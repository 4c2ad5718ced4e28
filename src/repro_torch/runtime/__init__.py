from repro_torch.runtime.fault_tolerance import (FaultConfig,  # noqa: F401
                                                 ResilientTrainer)
