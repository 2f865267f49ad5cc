"""The benchmark's CPU tests of the ``graph_replay_share.decode`` reader
(``cardbench/tests/test_cardbench_graph_replay_share.py``), collected here
too: the suite's ``testpaths`` holds ``tests`` alone."""
from cardbench.tests.test_cardbench_graph_replay_share import (  # noqa: F401
    spans,
    test_cardbench_graph_replay_share_finds_nothing,
    test_cardbench_graph_replay_share_reader,
)
