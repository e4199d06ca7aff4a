"""Chain-batched target calls per NUTS transition over the window: the
program's TreeStats lockstep_leaves over transitions, the leaves the card
ran for the longest tree of each depth. None where the program counts no
trees."""


def read(run):
    c = run.counters
    if not c.get("transitions"):
        return None
    return c["lockstep_leaves"] / c["transitions"]
