"""The plain reference: float32 PyTorch with TF32 off, written from the
published architecture and the training step's equations.  It imports
nothing of the program under test."""
