"""A frozen copy of the port's plain code, the benchmark's reference.

Taken from the port's package (its module layout kept, so relative
imports hold), cut to what the cells run: every kernel replaced by its
plain version as torch ops, which ``render/trace.py`` calls directly
(``accel/sweep.py`` for K5c / K5a, ``accel/traverse.py`` for K3 / K4;
``render/nlm.py`` for K2), the BVH builders held to NumPy (no native
builder) and the mesh cache moved to the benchmark's own
``_data/refcache``. The debug views, K7's cost walk and the shortlist
rounds of more than 12 big instances (K6) are left out: no cell runs them. One departure in
``render/lights.py``: an area light's samples ask for their shadow rays in
one occlusion query, not one query a sample (each ray's answer is its own,
so the answers are the same, in fewer calls of the plain walk). It imports nothing of
the port and nothing of JAX, and later changes to the port do not reach
it: it is the yardstick the port's timed path is compared with.
"""
