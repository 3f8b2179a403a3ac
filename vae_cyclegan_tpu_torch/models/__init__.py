"""Blocks, networks and tasks of the port (NCHW nn.Modules)."""
