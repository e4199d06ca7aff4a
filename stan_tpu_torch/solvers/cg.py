"""Jacobi-preconditioned conjugate gradients, float64 refinement, and the
certified solve.

Port of stan_tpu/solvers/cg.py (pcg, pcg_refined, pcg_certified) with the
same contract:

  * stop when ||r|| <= tol * ||b||;
  * maxiter == 0 means ndof (the exact-termination bound);
  * a NaN or a residual past 1e8 x ||b|| stops the loop and sets
    ``diverged``; ``converged`` says whether the threshold was met.

The JAX loop runs on the device (lax.while_loop). Here the loop is Python,
so the stopping test reads ||r|| on the host: one device sync per
iteration, which keeps the iteration count identical to the reference's.
Everything else in the iteration stays on the device.

One system on a CUDA device without ``dot`` (every single-process
unbatched solve) runs the same iteration as a CUDA graph of BLOCK
iterations instead, on static tensors updated in place, with the stopping
test on the device: the graph is replayed until the test fails and the
host reads the stopping state once per replay. From the iteration whose
test fails, x, the count and the reported norm stay frozen for the rest
of the block, so the result is the per-iteration loop's to the bit. One
capture serves every right-hand side, tolerance and cap of the same
operator callable (compared by identity; a bound method by its object)
on vectors of the same shape, layout and dtype; the last one is kept, and
a new key drops it. With ``dot``, or on the CPU, the loop reads every
iteration.

``pcg(..., batched=True)`` solves B independent systems at once (HMC
chains): b carries a leading chain axis, A acts on the whole batch, and
every reduction and threshold is per chain. It does what JAX's vmapped
while_loop does: the loop runs while any chain runs, and a chain that has
stopped is frozen with torch.where and its counter stops, so each chain's
iterations, residual and flags are those of its own solve.

``pcg(system, b, params=p, batched=True)`` takes a problem's system in
place of the operator: system(*p) -> (matvec, diag). On a CUDA device without
``dot`` it runs the batched iteration as the same replayed blocks, with
each chain's stopping test and freeze on the device and one host read of
every chain's state a block; the result is the per-iteration batched
loop's to the bit. The capture reads the parameters from static copies
that each call refills, so one capture serves every parameter value of
one problem (the object system is bound to) on parameters and vectors of
the same shape, layout and dtype; the captures of a problem are kept
while it lives, one for each such key. Elsewhere, or with ``dot``, the
system is built and the loop reads every iteration.

``dot`` is the reduction, as ``axis_name`` is the reference's: a
domain-sharded solve passes parallel.distributed.Slabs.dot with vectors
sharded over a device mesh (parallel/sharded_stencil.py,
parallel/sharded.py), and the recurrence stays this one. Over several
processes every host decision here (the norms read at each iteration, the
run mask of a batched solve) is taken on each process from dot's values,
so dot must return the same bits on every process (Slabs.dot does), and
b.device must be a device of this process (Slabs.device, the mesh's
home); then every process stops at the same iteration.

Spans and counters (utils/timing.span, on the profiler's timeline only
while one records): every pcg call is the span "cg.pcg", and its result
carries the call's host nanoseconds (``wall_ns``; the call ends on a norm
read, which waits for the device, so this holds the device work it queued)
and those spent blocked in its host reads of the norms (``wait_ns``); their
difference is the host's own time, dispatch included. ``reads`` counts
those reads and ``frozen`` the iterations a replayed block ran after the
stop (the slowest chain's, in a batched solve). Iterations are counted,
not spanned; a capture is "cg.capture".
The float64 refinement loop under pcg_refined and pcg_certified runs its
residual sweeps as "certify.sweep" and its corrections as "certify.inner".
"""

from __future__ import annotations

import functools
import inspect
import math
import time
import weakref
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from stan_tpu_torch.fem import launches
from stan_tpu_torch.utils.timing import span

# CG iterations per replayed CUDA graph. The host reads the stopping state
# once per block, and the last block runs on frozen after the stop: on
# average (BLOCK - 1) / 2 iterations a call of device work, about 2% of the
# ~375 iterations of a 70^3 load case's correction solve, for one host
# read and one graph launch per 16 iterations instead of one read and ~35
# launches per iteration.
BLOCK = 16


class CGResult(NamedTuple):
    """One solve's result; with batched=True, iters, residual, converged and
    diverged are numpy arrays with one entry per chain."""

    u: torch.Tensor
    iters: int
    residual: float  # final ||r||
    converged: bool
    diverged: bool = False  # NaN / blow-up guard tripped
    wall_ns: int = 0  # host time of the call (module docstring)
    wait_ns: int = 0  # of it, blocked in the host reads of the norms
    reads: int = 0  # host reads of the norms (or of a block's state)
    frozen: int = 0  # iterations run after the stop (replayed blocks)


class _Reads:
    """Host reads of norms on the device by `to_host` (each waits for the
    device), their number and the nanoseconds spent blocked in them."""

    def __init__(self, to_host):
        self.to_host, self.ns, self.n = to_host, 0, 0

    def __call__(self, norm: torch.Tensor):
        t = time.perf_counter_ns()
        value = self.to_host(norm)
        self.ns += time.perf_counter_ns() - t
        self.n += 1
        return value


def pcg(
    A: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    *,
    diag: Optional[torch.Tensor] = None,
    tol: float = 1.0e-6,
    maxiter: int = 0,
    ndof: Optional[int] = None,
    x0: Optional[torch.Tensor] = None,
    batched: bool = False,
    dot: Optional[Callable] = None,
    params: Optional[tuple] = None,
) -> CGResult:
    """Solve A u = b with Jacobi-preconditioned CG.

    A: SPD operator; b: right-hand side of any shape (reductions run over
    all elements); diag: diagonal of A for the preconditioner (None: none);
    maxiter 0 caps at ndof, which defaults to b.numel(); x0: initial guess
    (zeros by default). batched: axis 0 of b is a chain axis of independent
    systems (see the module docstring); ndof is then per chain and defaults
    to b[0].numel(). dot: (u, v) -> Σ u·v, a scalar, or per chain [B] when
    batched (default: torch sums over the tensor, or over each chain's
    elements). params: A is then a system, A(*params) -> (matvec, diag),
    and diag is not given (see the module docstring).
    """
    t0 = time.perf_counter_ns()
    with span("cg.pcg"):
        if params is not None and batched and dot is None and _blocked(b):
            res = _pcg_system(A, params, b, tol, maxiter, ndof, x0)
        else:
            if params is not None:
                A, diag = A(*params)
            res = (_pcg_batched if batched else _pcg_one)(
                A, b, diag, tol, maxiter, ndof, x0, dot)
    return res._replace(wall_ns=time.perf_counter_ns() - t0)


def _blocked(b) -> bool:
    """Whether a system's batched loop runs in blocks on b's device: on a
    CUDA device, where they are captured."""
    return b.device.type == "cuda"


def _setup(b, diag, tol, maxiter, ndof, batched=False):
    """What every loop sets up: (the iteration cap, maxiter 0 meaning ndof,
    which defaults to the size of b or of one chain's b; the inverse Jacobi
    diagonal, 0 where diag is, or None; bounds: ||b|| -> (threshold,
    blow-up), with ||b|| no smaller than b's dtype's tiny)."""
    if maxiter == 0:
        maxiter = int(ndof if ndof is not None
                      else (b[0] if batched else b).numel())
    inv_diag = None if diag is None else torch.where(
        diag != 0, 1.0 / diag, torch.zeros_like(diag))
    tiny = torch.finfo(b.dtype).tiny

    def bounds(bnorm):
        bnorm = max(bnorm, tiny)
        return tol * bnorm, 1.0e8 * bnorm

    return maxiter, inv_diag, bounds


def _pcg_one(A, b, diag, tol, maxiter, ndof, x0, dot) -> CGResult:
    """pcg of one system; wait_ns set, wall_ns left to pcg."""
    if dot is None and b.device.type == "cuda":
        with torch.no_grad():
            return _pcg_blocks(A, b, diag, tol, maxiter, ndof, x0,
                               lambda *state: _captured(A, *state))
    if dot is None:
        def dot(u, v):
            return torch.sum(u * v)
    maxiter, inv_diag, bounds = _setup(b, diag, tol, maxiter, ndof)

    def precond(r):
        return r if inv_diag is None else inv_diag * r

    x = torch.zeros_like(b) if x0 is None else x0
    r = b - A(x)
    z = precond(r)
    p = z
    rz = dot(r, z)
    read = _Reads(float)
    threshold, blowup = bounds(read(torch.sqrt(dot(b, b))))

    def bad(rnorm):
        return not math.isfinite(rnorm) or rnorm > blowup

    rnorm = read(torch.sqrt(dot(r, r)))
    k = 0
    while rnorm > threshold and k < maxiter and not bad(rnorm):
        Ap = A(p)
        alpha = rz / dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_n = dot(r, z)
        beta = rz_n / rz
        p = z + beta * p
        rz = rz_n
        k += 1
        rnorm = read(torch.sqrt(dot(r, r)))  # the per-iteration sync
    return CGResult(u=x, iters=k, residual=rnorm,
                    converged=rnorm <= threshold, diverged=bad(rnorm),
                    wait_ns=read.ns, reads=read.n)


def _dot(u, v):
    return torch.sum(u * v)


class _Blocks:
    """_pcg_one's iteration (dot None) on static tensors updated in place,
    with its stopping test on the device. `step` runs k iterations; from
    the one whose test fails, x, the count and the reported norm keep their
    values (frozen) while the rest of the recurrence runs on unread, and it
    ends by writing (run, count, norm) to `status` for one host read.
    `capture` records step as a CUDA graph, and `replay` launches it (or
    runs step eagerly, uncaptured). The blocks hold no reference to the
    operator: the caller's A keeps what the graph reads alive.

    x, r and p take the strides of _pcg_one's x, r and z (and inv_diag
    those of its own), which its elementwise operations keep from one
    iteration to the next: a reduction's order, hence its bits, follows
    its operand's layout."""

    def __init__(self, x, r, z, inv_diag, k: int):
        self.k, self.graph, self.launches = k, None, None
        self.x, self.r, self.p = (torch.zeros_like(t) for t in (x, r, z))
        self.inv_diag = (None if inv_diag is None
                         else torch.zeros_like(inv_diag))

        def scalar(dtype):
            return torch.zeros((), dtype=dtype, device=r.device)

        self.rz, self.rnorm = scalar(r.dtype), scalar(r.dtype)
        self.iters, self.maxiter = scalar(torch.int64), scalar(torch.int64)
        self.run = scalar(torch.bool)
        self.threshold, self.blowup = (scalar(torch.float64),
                                       scalar(torch.float64))
        self.status = torch.zeros(3, dtype=torch.float64, device=r.device)

    def step(self, A) -> None:
        x, r, p, run = self.x, self.r, self.p, self.run
        for _ in range(self.k):
            # _pcg_one's operations in its order; in place where it
            # rebinds (the same values: IEEE + and * commute).
            Ap = A(p)
            alpha = self.rz / _dot(p, Ap)
            torch.where(run, x + alpha * p, x, out=x)
            r.sub_(alpha * Ap)
            z = r if self.inv_diag is None else self.inv_diag * r
            rz_n = _dot(r, z)
            beta = rz_n / self.rz
            p.mul_(beta).add_(z)
            self.rz.copy_(rz_n)
            torch.where(run, torch.sqrt(_dot(r, r)), self.rnorm,
                        out=self.rnorm)
            self.iters.add_(run)
            self.test()
        torch.stack([run.double(), self.iters.double(), self.rnorm.double()],
                    out=self.status)

    def test(self) -> None:
        """_pcg_one's test in float64 on the float32 norm, into run: above
        the threshold, finite and not past the blow-up, under the cap.
        rnorm <= blowup is false for NaN and inf (blowup is finite), so it
        holds the finiteness test too."""
        rnorm = self.rnorm.double()
        torch.logical_and(rnorm > self.threshold, rnorm <= self.blowup,
                          out=self.run)
        self.run.logical_and_(self.iters < self.maxiter)

    def capture(self, A) -> "_Blocks":
        """Warm step up on a side stream, then record it as a CUDA graph.
        The wrapper calls that recorded it launched nothing, so their
        counts leave fem/launches' counters and each replay adds them."""
        device = self.x.device
        with span("cg.capture"), torch.cuda.device(device):
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                self.step(A)
                side.synchronize()
                before = launches.snapshot()
                self.graph = torch.cuda.CUDAGraph()
                self.graph.capture_begin()
                try:
                    self.step(A)
                finally:
                    self.graph.capture_end()
            torch.cuda.current_stream(device).wait_stream(side)
        self.launches = launches.snapshot() - before
        launches.add(self.launches, -1)
        return self

    def replay(self, A) -> None:
        if self.graph is None:
            self.step(A)
        else:
            self.graph.replay()
            launches.add(self.launches)


# The last capture: (its key, a weak reference to its operator, _Blocks).
_last = None


def _layout(t):
    """What a capture's key holds of a tensor (or None)."""
    return None if t is None else (t.shape, t.stride(), t.dtype, t.device)


def _weak(A):
    """A reference to A that does not keep it alive, where A allows one."""
    try:
        return (weakref.WeakMethod if inspect.ismethod(A) else weakref.ref)(A)
    except TypeError:  # a builtin takes no weak reference: hold it
        return lambda: A


def _captured(A, *state) -> _Blocks:
    """Captured blocks for A on tensors like state (x, r, z, inv_diag):
    the last ones if they match, else captured now."""
    global _last
    key = tuple(map(_layout, state))
    # Bound methods compare equal when they bind the same object (by
    # identity) to the same function; functions when they are one.
    if _last is not None and _last[0] == key and _last[1]() == A:
        return _last[2]
    _last = None  # the old graph and state go before the new ones come
    _last = (key, _weak(A), _Blocks(*state, BLOCK).capture(A))
    return _last[2]


def _pcg_blocks(A, b, diag, tol, maxiter, ndof, x0, blocks_for) -> CGResult:
    """_pcg_one (dot None) in blocks: its set-up, with ||b|| and the first
    ||r|| read together, then the blocks of blocks_for(x, r, z, inv_diag)
    replayed until the device's test stops, each followed by one host read
    of its status. Returns a copy of x: the blocks' state serves the next
    call."""
    maxiter, inv_diag, bounds = _setup(b, diag, tol, maxiter, ndof)
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - A(x)
    z = r if inv_diag is None else inv_diag * r
    rz = _dot(r, z)
    read = _Reads(torch.Tensor.tolist)
    bnorm, rnorm = read(torch.stack([torch.sqrt(_dot(b, b)),
                                     torch.sqrt(_dot(r, r))]))
    threshold, blowup = bounds(bnorm)
    run = (rnorm > threshold and maxiter > 0 and math.isfinite(rnorm)
           and rnorm <= blowup)
    k = ran = 0  # iterations counted, and run by the device
    if run:
        s = blocks_for(x, r, z, inv_diag)
        for static, value in ((s.x, x), (s.r, r), (s.p, z), (s.rz, rz),
                              (s.inv_diag, inv_diag)):
            if value is not None:
                static.copy_(value)
        s.rnorm.fill_(rnorm)
        s.iters.zero_()
        s.maxiter.fill_(maxiter)
        s.threshold.fill_(threshold)
        s.blowup.fill_(blowup)
        s.run.fill_(True)
        while run:
            s.replay(A)
            ran += s.k
            run, k, rnorm = read(s.status)
        k = int(k)
        x = s.x.clone()
    return CGResult(u=x, iters=k, residual=rnorm,
                    converged=rnorm <= threshold,
                    diverged=not math.isfinite(rnorm) or rnorm > blowup,
                    wait_ns=read.ns, reads=read.n, frozen=ran - k)


def _chain_dot(u, v):
    """Σ u·v per chain, over each chain's elements in order: [B]."""
    return torch.sum((u * v).reshape(u.shape[0], -1), dim=1)


class _ChainBlocks(_Blocks):
    """_pcg_batched's iteration (dot None) on static tensors, as _Blocks
    runs _pcg_one's: rz, the norms, the counts, the run flags and the
    bounds per chain ([B]), and a chain whose test fails is frozen with
    torch.where there as in _pcg_batched, so a block run past the slowest
    chain's stop changes nothing. The status is (run, count, norm) of
    every chain, [3, B]."""

    def __init__(self, x, r, z, inv_diag, k: int):
        super().__init__(x, r, z, inv_diag, k)
        B = r.shape[0]

        def chains(dtype):
            return torch.zeros(B, dtype=dtype, device=r.device)

        self.rz, self.rnorm = chains(r.dtype), chains(r.dtype)
        self.iters, self.run = chains(torch.int64), chains(torch.bool)
        self.bounds = torch.zeros(2, B, dtype=torch.float64, device=r.device)
        self.threshold, self.blowup = self.bounds
        self.status = torch.zeros(3, B, dtype=torch.float64, device=r.device)

    def step(self, A) -> None:
        x, r, p, run = self.x, self.r, self.p, self.run
        wide = (r.shape[0],) + (1,) * (r.dim() - 1)
        wide_run = run.view(wide)
        for _ in range(self.k):
            # _pcg_batched's operations in its order, into the static
            # tensors where it rebinds.
            Ap = A(p)
            alpha = (self.rz / _chain_dot(p, Ap)).view(wide)
            torch.where(wide_run, x + alpha * p, x, out=x)
            r_n = r - alpha * Ap
            z = r_n if self.inv_diag is None else self.inv_diag * r_n
            rz_n = _chain_dot(r_n, z)
            torch.where(wide_run, z + (rz_n / self.rz).view(wide) * p, p,
                        out=p)
            torch.where(wide_run, r_n, r, out=r)
            torch.where(run, rz_n, self.rz, out=self.rz)
            # A frozen chain's r is unchanged, and so is its norm.
            torch.sqrt(_chain_dot(r, r), out=self.rnorm)
            self.iters.add_(run)
            self.test()  # per chain
        torch.stack([run.double(), self.iters.double(), self.rnorm.double()],
                    out=self.status)


def _pcg_chains(A, b, diag, tol, maxiter, ndof, x0, blocks_for) -> CGResult:
    """_pcg_batched (dot None) in blocks: its set-up, with every chain's
    ||b|| and first ||r|| read together, then the blocks of blocks_for(x,
    r, z, inv_diag) -> (blocks, the matvec they step with) replayed until no
    chain runs, each followed by one host read of its status. Returns a
    copy of x, as _pcg_blocks does."""
    B = b.shape[0]
    maxiter, inv_diag, bounds = _setup(b, diag, tol, maxiter, ndof, True)
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - A(x)
    z = r if inv_diag is None else inv_diag * r
    rz = _chain_dot(r, z)
    read = _Reads(torch.Tensor.tolist)
    norms = torch.stack([torch.sqrt(_chain_dot(b, b)),
                         torch.sqrt(_chain_dot(r, r))])
    bnorm, rnorm = read(norms)
    threshold, blowup = zip(*map(bounds, bnorm))
    go = [rnorm[c] > threshold[c] and maxiter > 0
          and math.isfinite(rnorm[c]) and rnorm[c] <= blowup[c]
          for c in range(B)]
    k, ran = [0] * B, 0  # iterations counted, and run by the device
    if any(go):
        s, A = blocks_for(x, r, z, inv_diag)
        for static, value in ((s.x, x), (s.r, r), (s.p, z), (s.rz, rz),
                              (s.inv_diag, inv_diag), (s.rnorm, norms[1])):
            if value is not None:
                static.copy_(value)
        s.iters.zero_()
        s.maxiter.fill_(maxiter)
        s.bounds.copy_(torch.tensor([threshold, blowup], dtype=torch.float64))
        s.test()  # go, on the device
        while any(go):
            s.replay(A)
            ran += s.k
            go, k, rnorm = read(s.status)
        k = [int(n) for n in k]
        x = s.x.clone()
    return CGResult(
        u=x, iters=np.array(k), residual=np.array(rnorm),
        converged=np.array([rnorm[c] <= threshold[c] for c in range(B)]),
        diverged=np.array([not math.isfinite(rnorm[c])
                           or rnorm[c] > blowup[c] for c in range(B)]),
        wait_ns=read.ns, reads=read.n, frozen=ran - max(k))


class _System(NamedTuple):
    """One capture of a problem's batched loop: the static copies of the
    parameters it reads, the matvec built on them (it keeps alive what the
    graph reads) and the captured blocks."""

    params: tuple
    A: Callable
    blocks: _ChainBlocks


# The captures of each live problem: id(problem) -> (a weak reference to
# it, whose callback drops the entry, {key: _System}).
_systems = {}


def _captures(system) -> dict:
    """The captures kept for system's problem, the object it is bound to
    (or system itself), for as long as that lives."""
    owner = getattr(system, "__self__", system)
    entry = _systems.get(id(owner))
    if entry is None:
        def drop(_, key=id(owner)):
            _systems.pop(key, None)

        entry = _systems[id(owner)] = (weakref.ref(owner, drop), {})
    return entry[1]


def _weakly_bound(system):
    """system with the object it is bound to referenced weakly, so that the
    matvec it builds for a capture does not keep its problem alive."""
    if inspect.ismethod(system):
        return functools.partial(system.__func__,
                                 weakref.proxy(system.__self__))
    return system


def _pcg_system(system, params, b, tol, maxiter, ndof, x0) -> CGResult:
    """The batched loop of system(*params) in replayed blocks: the call's
    diagonal and first residual come from system(*params) run eagerly, its
    parameters go into the static copies of the capture for their layout
    (made now if there is none), and _pcg_chains replays it."""
    with torch.no_grad():
        A, diag = system(*params)
        captures = _captures(system)

        def blocks_for(*state):
            key = (getattr(system, "__func__", None),
                   *map(_layout, (*params, *state)))
            got = captures.get(key)
            if got is None:
                static = tuple(p.clone() for p in params)
                matvec = _weakly_bound(system)(*static)[0]
                blocks = _ChainBlocks(*state, BLOCK)
                if b.device.type == "cuda":
                    blocks.capture(matvec)
                got = captures[key] = _System(static, matvec, blocks)
            for s, p in zip(got.params, params):
                s.copy_(p)
            return got.blocks, got.A

        return _pcg_chains(A, b, diag, tol, maxiter, ndof, x0, blocks_for)


def _pcg_batched(A, b, diag, tol, maxiter, ndof, x0, dot) -> CGResult:
    """pcg over a leading chain axis; the stopping test of every chain is
    the unbatched one, on its own norms, read together once per
    iteration."""
    B = b.shape[0]
    maxiter, inv_diag, bounds = _setup(b, diag, tol, maxiter, ndof, True)
    wide = (B,) + (1,) * (b.dim() - 1)

    def precond(r):
        return r if inv_diag is None else inv_diag * r

    if dot is None:
        dot = _chain_dot

    x = torch.zeros_like(b) if x0 is None else x0
    r = b - A(x)
    z = precond(r)
    p = z
    rz = dot(r, z)
    read = _Reads(torch.Tensor.tolist)
    bnorm, rnorm = read(torch.stack([torch.sqrt(dot(b, b)),
                                     torch.sqrt(dot(r, r))]))
    threshold, blowup = zip(*map(bounds, bnorm))

    def bad(c):
        return not math.isfinite(rnorm[c]) or rnorm[c] > blowup[c]

    k = [0] * B

    def going():
        return [rnorm[c] > threshold[c] and k[c] < maxiter and not bad(c)
                for c in range(B)]

    go = going()
    while any(go):
        run = torch.tensor(go, device=b.device)
        wide_run = run.view(wide)
        Ap = A(p)
        alpha = (rz / dot(p, Ap)).view(wide)
        x = torch.where(wide_run, x + alpha * p, x)
        r_n = r - alpha * Ap
        z = precond(r_n)
        rz_n = dot(r_n, z)
        p = torch.where(wide_run, z + (rz_n / rz).view(wide) * p, p)
        r = torch.where(wide_run, r_n, r)
        rz = torch.where(run, rz_n, rz)
        rnorm = read(torch.sqrt(dot(r, r)))  # the per-iteration sync
        k = [k[c] + go[c] for c in range(B)]
        go = going()
    return CGResult(
        u=x, iters=np.array(k), residual=np.array(rnorm),
        converged=np.array([rnorm[c] <= threshold[c] for c in range(B)]),
        diverged=np.array([bad(c) for c in range(B)]), wait_ns=read.ns,
        reads=read.n)


class RefinedResult(NamedTuple):
    u: torch.Tensor      # float64 solution
    cycles: int          # number of low-precision correction solves run
    rel_residual: float  # true ||b - A_hi u|| / ||b|| (float64)
    inner_iters: int     # total low-precision CG iterations
    converged: bool
    # Wall time of the float64 residual sweeps and of the inner solves.
    sweep_seconds: float = 0.0
    inner_seconds: float = 0.0


def _refine(inner, b64, A_hi, *, tol, floor, max_cycles, lo_dtype,
            x0=None) -> RefinedResult:
    """The float64 refinement loop of pcg_refined and pcg_certified.

    Each cycle solves the correction A d = r in lo_dtype with
    inner(r_lo, t), adds d to x in float64 and computes the true residual
    r = b - A_hi(x) in float64 on b64's device; the loop stops when
    ||r|| <= tol ||b||, after max_cycles corrections, or when a cycle does
    not lower the residual (the low-precision correction floor), returning
    that cycle's x. A cycle's tolerance is clip(0.3 tol / rel, floor,
    3e-2): the early cycles contract by floor, and the one that can finish
    the job goes no deeper than the remaining gap needs (each restart pays
    for a new Krylov space). x0 None starts x at zero, whose residual is b
    exactly: no sweep is run for it."""
    bnorm = float(torch.linalg.vector_norm(b64))
    if bnorm == 0.0:
        return RefinedResult(torch.zeros_like(b64), 0, 0.0, 0, True)
    sweep_s = inner_s = 0.0

    def sweep(x):
        nonlocal sweep_s
        t0 = time.perf_counter()
        with span("certify.sweep"):
            r = b64 - A_hi(x)
            rel = float(torch.linalg.vector_norm(r)) / bnorm
        sweep_s += time.perf_counter() - t0
        return r, rel

    if x0 is None:
        x, r, rel = torch.zeros_like(b64), b64, 1.0
    else:
        x = x0.to(b64)
        r, rel = sweep(x)
    prev_rel = math.inf
    cycles = iters = 0
    while rel > tol and cycles < max_cycles and rel < prev_rel:
        t = min(max(0.3 * tol / rel, floor), 3.0e-2)
        t0 = time.perf_counter()
        with span("certify.inner"):
            res = inner(r.to(lo_dtype), t)
            iters += res.iters
            cycles += 1
            x = x + res.u.to(x)
        inner_s += time.perf_counter() - t0
        prev_rel = rel
        r, rel = sweep(x)
    return RefinedResult(x, cycles, rel, iters, rel <= tol, sweep_s, inner_s)


def pcg_refined(
    A,
    b_hi: torch.Tensor,
    A_hi: Callable[[torch.Tensor], torch.Tensor],
    *,
    diag=None,
    tol: float = 1.0e-6,
    maxiter: int = 0,
    ndof: Optional[int] = None,
    max_cycles: int = 6,
    lo_dtype=torch.float32,
    x0: Optional[torch.Tensor] = None,
    inner_solve=None,
) -> RefinedResult:
    """Mixed-precision iterative refinement: low-precision CG corrections
    under a float64 true-residual outer loop (_refine), from the warm start
    x0 (None: zero), with the cycle tolerance floored at 8 eps_lo: below
    it the low-precision recurrence cannot reliably reach its own
    threshold. As in the JAX package, each cycle retires about 1.5 decades
    and the product of cycles reaches tol.

    x and r live in float64 on b_hi's device, and each correction comes
    back to it: with b_hi on the host, the loop is the reference's host
    loop and only the corrections run on the device.

    A: low-precision operator (used when inner_solve is None); A_hi: the
    float64 operator on b_hi's device (analysis/linear.py passes the host
    twin of fem/hostops.py, independent of the device code); inner_solve:
    (r_lo, tol) -> CGResult for the corrections, r_lo on b_hi's device
    (it moves r_lo to its own device); x0: float64 warm start (e.g. the
    base solve's solution), moved to b_hi's device.
    """
    inner = inner_solve if inner_solve is not None else (
        lambda r, t: pcg(A, r, diag=diag, tol=t, maxiter=maxiter, ndof=ndof))
    return _refine(inner, b_hi.to(torch.float64), A_hi, tol=tol,
                   floor=8.0 * torch.finfo(lo_dtype).eps,
                   max_cycles=max_cycles, lo_dtype=lo_dtype, x0=x0)


class CertifiedResult(NamedTuple):
    u: torch.Tensor      # float64 solution, on the operator's device
    cycles: int          # correction solves run
    rel_residual: float  # true ||b - hi_apply(u)|| / ||b|| (float64)
    inner_iters: int     # total low-precision CG iterations across cycles
    converged: bool
    # Wall time of the solve; with measure=True, of a second run.
    seconds: float = 0.0


def pcg_certified(
    A: Callable[[torch.Tensor], torch.Tensor],
    b64: torch.Tensor,
    hi_apply: Callable[[torch.Tensor], torch.Tensor],
    *,
    diag: torch.Tensor,
    tol: float = 1.0e-6,
    inner_tol: float = 5.0e-3,
    maxiter: int = 0,
    ndof: Optional[int] = None,
    max_cycles: int = 10,
    measure: bool = False,
) -> CertifiedResult:
    """Certified solve from zero: restarted low-precision CG cycles under a
    float64 true-residual loop (_refine), the JAX package's schedule, with
    the cycle tolerance floored at inner_tol. inner_tol must sit above the
    low-precision correction floor (about eps32 times the condition number,
    ~2e-3 at 1M DOF).

    The reference keeps x as a (hi, lo) float32 pair and computes the
    residual with a compensated float32 sweep (fem/df32.py), because the
    TPU has no float64. The card has native float64: x and r are float64
    tensors on the device, and hi_apply is a float64 operator there (the
    float64 StencilOperator's apply: the sweep's double instantiation). x
    and r stay on the device; the host reads rel once per cycle, besides
    the inner pcg's own reads (on the card one per replayed block of BLOCK
    iterations).

    A: fast low-precision operator; b64: right-hand side (float64, cast if
    not), on A's device; hi_apply: the float64 operator on the same
    device; diag: A's Jacobi diagonal, whose dtype is that of the inner
    solves; maxiter 0 caps each inner solve at ndof (default b64.numel()).
    measure: run the solve twice and report the second run's wall time.
    """
    b64 = torch.as_tensor(b64, dtype=torch.float64, device=diag.device)

    def timed():
        t0 = time.perf_counter()
        out = _refine(
            lambda r, t: pcg(A, r, diag=diag, tol=t, maxiter=maxiter,
                             ndof=ndof),
            b64, hi_apply, tol=tol, floor=inner_tol, max_cycles=max_cycles,
            lo_dtype=diag.dtype)
        if b64.device.type == "cuda":
            torch.cuda.synchronize(b64.device)
        return out, time.perf_counter() - t0

    res, dt = timed()
    if measure:
        res, dt = timed()
    return CertifiedResult(res.u, res.cycles, res.rel_residual,
                           res.inner_iters, res.converged, dt)
