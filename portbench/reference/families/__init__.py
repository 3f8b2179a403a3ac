"""One file per architecture, ``<architecture>.py`` as a configuration's
``architecture`` names it, each with ``FAMILY``: a ``steps.Family``
subclass. ``steps.family`` finds it by that name, so a configuration of
another architecture adds its file and edits none."""
