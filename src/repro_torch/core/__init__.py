"""The memory predictor: spec trees, Eq.1 factors, assembly, the planner's
OoM check and the capacity sweep (host columnar path + torch engine)."""
