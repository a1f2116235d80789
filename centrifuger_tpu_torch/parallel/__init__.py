"""Sharded-index serving (sharded.py, kernel K10) and the data-parallel step
(mesh.py, kernel K11): the port of centrifuger_tpu.parallel."""
