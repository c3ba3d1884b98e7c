"""CPU tests of the benchmark (``python -m pytest portbench/tests -q``) and,
marked ``cuda``, its checks on the card."""
