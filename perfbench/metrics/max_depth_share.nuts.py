"""The share, in %, of the window's chain-transitions whose NUTS tree
stopped at max_depth, not at a U-turn or a divergence (TreeStats
at_max_depth over chain_transitions). None where the program counts no
trees."""


def read(run):
    c = run.counters
    if not c.get("chain_transitions"):
        return None
    return 100.0 * c["at_max_depth"] / c["chain_transitions"]
