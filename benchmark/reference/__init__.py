"""Plain PyTorch and NumPy reference of what the benchmark's cells run.

It follows the published DH3D description (reference code
`core/model.py`, `core/backbones.py`, `core/layers.py`, `core/losses.py`,
`core/utils.py`) in float32 with no hand-written kernel, no cache and no
batching trick.  Nothing here imports the program under test: its
neighbour searches, samplers, sorts and losses are written out again
(frozen copies of the semantics, not of the code paths).
"""
