"""The roofline of the port's steps on the H100.

``op_counter`` counts the FLOPs (by input type), bytes, attention volume
and kernel calls of an eager step on ``meta`` or ``cuda`` tensors;
``kernel_costs`` prices each hand-written kernel's call; ``analysis``
turns a count into the three roofline terms of a dry-run cell (port of
``repro.roofline``).  Import the modules by name: the kernel wrappers
import ``op_counter``.
"""
