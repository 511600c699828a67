"""The benchmark's plain reference: a frozen copy of the port's plain code
(``tinsel_ref``) driven by ``side.py``, and the low-precision control
(``lowp.py``). Nothing here imports the port or JAX."""
