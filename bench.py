#!/usr/bin/env python
"""Headline E-step benchmark on one GPU; see strutopy_tpu/bench.py."""

from strutopy_tpu.bench import main

if __name__ == "__main__":
    main()
