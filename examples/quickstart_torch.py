#!/usr/bin/env python
"""Quickstart of the PyTorch port: tune a schedule with ProTuner (MCTS) for
the H100, train granite-moe-1b-a400m with it on the card, then serve.

    python examples/quickstart_torch.py                       # on an H100
    python examples/quickstart_torch.py --device cpu --smoke  # reduced config, CPU

The steps are ``repro_torch.launch.quickstart``'s.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.quickstart import main  # noqa: E402

if __name__ == "__main__":
    raise SystemExit(main())
