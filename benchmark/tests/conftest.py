"""The benchmark's CPU tests: the checkout's root and this folder on
the import path (``benchmark`` is a package of the root; ``tiny`` holds
the cells at test sizes). Nothing here needs a card."""
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for p in (HERE.parents[1], HERE):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
