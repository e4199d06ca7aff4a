"""The share, in %, of the NUTS batch's chain-leaves that a chain still
needed: TreeStats chain_leaves over chains x lockstep_leaves (a chain whose
tree has stopped rides along until the batch's last one stops). None where
the program counts no trees."""


def read(run):
    c = run.counters
    if not c.get("lockstep_leaves"):
        return None
    chains = run.cell.workload["traffic"]["chains"]
    return 100.0 * c["chain_leaves"] / (chains * c["lockstep_leaves"])
