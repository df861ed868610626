"""Published peaks of the card the cells run on.

NVIDIA H100 SXM5 80 GB data sheet, at its 700 W limit: HBM3 at
3.35 TB/s.  A card set below 700 W runs slower than this; the harness
prints the card's power limit beside every run.
"""

HBM_BYTES_PER_S = 3.35e12
