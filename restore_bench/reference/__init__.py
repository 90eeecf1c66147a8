"""Plain references the benchmark's verdict rests on: a PigMix plan
evaluator and a float32 MiniCPM3 forward pass, in plain PyTorch.
Neither imports the program; each works out for itself whatever the
program derived from the inputs."""
