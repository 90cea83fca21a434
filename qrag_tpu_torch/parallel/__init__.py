"""Training on one device (``train.py``); the mesh, the sharded index
and the sharded trainer are not ported yet (ROADMAP.md, Queue 1 item 8)."""
