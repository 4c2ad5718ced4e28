"""How the benchmark builds the program under test, one module per model
family: the program's configuration of the model from the benchmark's
configuration file."""
