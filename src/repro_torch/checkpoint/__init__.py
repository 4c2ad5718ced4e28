from repro_torch.checkpoint.checkpointing import (Checkpointer,  # noqa: F401
                                                  latest_step,
                                                  load_checkpoint,
                                                  save_checkpoint)
