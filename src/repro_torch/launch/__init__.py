"""Launchers of the port: serving (``launch/serve.py``), training
(``launch/train.py``) and the device meshes (``launch/mesh.py``); the
dry-run waits for ROADMAP queue 1, item 12."""
