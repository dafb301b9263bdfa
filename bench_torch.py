#!/usr/bin/env python3
"""dsptpu's bench.py on the PyTorch / CUDA port (dsptpu_torch.bench).

    python3 bench_torch.py                            # the card, full size
    python3 bench_torch.py --device cpu --scale 100   # plain versions
    python3 bench_torch.py --hosts 4 [n]              # weak scaling

Prints one JSON line to stdout (metric, value, unit, vs_baseline,
extra) and the detail to stderr; exits 1 on a failed config, a witness
past its tolerance or an empty profile.
"""

import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dsptpu_torch.bench import main
    raise SystemExit(main())
