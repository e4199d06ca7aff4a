"""The share, in %, of the batched CG loops' chain-iterations that a
chain still needed: per-chain iterations over chains x loop iterations
(SolveStats; a chain that has stopped rides along until the slowest
one stops)."""


def read(run):
    c = run.counters
    loops = c["forward_loop_iters"] + c["adjoint_loop_iters"]
    chains = run.cell.workload["traffic"]["chains"]
    if not loops or chains < 2:
        return None
    return 100.0 * (c["forward_iters"] + c["adjoint_iters"]) / (chains * loops)
