"""Frozen arithmetic of the benchmark: the card's published peaks and
the operations and bytes of each measured unit of work, from shapes."""
