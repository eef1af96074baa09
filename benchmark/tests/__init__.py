"""CPU tests of the benchmark (and, marked ``cuda``, its runs on a card)."""
