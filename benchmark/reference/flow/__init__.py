"""Frozen copies of ntLink's host stages as the port runs them (pair tally,
scaffold graph, layout, stitch, overlap trim, merge), pure Python: the
reference's own, so that a change to the program cannot move them."""
