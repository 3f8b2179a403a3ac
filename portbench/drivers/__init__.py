"""Window drivers, one file per traffic kind (``<kind>.py``, each with a
``Cell`` class): ``train`` drives ``Engine.train_epoch``, ``serve``
``inference.run_inference``."""
