"""The folder's tests import the harness (``portbench/``) and the port
(the checkout's root) by name."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
for p in (str(HERE.parent), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)
