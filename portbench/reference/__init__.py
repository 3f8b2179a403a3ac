"""The plain reference: the two families' networks, losses and steps in
float32 PyTorch with every hand kernel replaced by its textbook op, the
data derivation it checks the loader and the on-card augmentation against,
and the FLOP count of ``mfu.*``. It imports nothing of the program."""
