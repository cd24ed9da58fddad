"""Launchers of the port: serving (``launch/serve.py``), training
(``launch/train.py``), the device meshes (``launch/mesh.py``) and the dry
run on meta tensors (``launch/dryrun.py``)."""
