"""Launchers of the port: so far the serving launcher (``launch/serve.py``);
mesh construction, the dry-run and training wait for ROADMAP queue 1,
items 11 and 12."""
