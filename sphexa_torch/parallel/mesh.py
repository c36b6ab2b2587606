"""Ranks, slabs and the sharded step (sphexa_tpu/parallel/mesh.py) on
``torch.distributed``.

The JAX package runs one controller over a device mesh under shard_map;
here each shard is a process (a rank) that holds one Hilbert-key slab.
The ownership model is the JAX package's: after each step's global SFC
sort, rank k owns rows [k S, (k + 1) S) of the sorted particles, S = N / P
(the sort is the domain redistribution, parallel/sort.py). Every rank runs
the same program; collectives are issued in program order, and every
decision a rank takes (re-size, rollback, flush) comes from replicated
scalars, so all ranks take the same one.

Backends: NCCL with rank r on ``cuda:r`` (P cards); gloo on the CPU (the
JAX package's ``--cpu-mesh`` role); gloo with CUDA tensors, which lets
several ranks share one card (NCCL refuses two ranks on one device) and
must be asked for explicitly: there every collective of this package goes
through pinned host buffers (``Mesh.staged``).

``spawn`` starts P ranks with torch.multiprocessing (spawn) and a
``file://`` rendezvous in a directory the caller gives; a rank that
raises or dies fails the launcher, which then stops the others.

Each collective below is one scope of ``kernels/costs.collective``: a
running audit tally (devtools/audit/tally.py) records it as one row on
the mesh's axis ``p`` with its logical operand and result, whatever the
staging; outside a tally the scope is a flag read.
"""

import dataclasses
import os
import pickle
import time
import uuid
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from sphexa_torch.device import resolve_device
from sphexa_torch.kernels import costs


@dataclasses.dataclass(eq=False)
class Mesh:
    """One rank's view of the 1-D particle mesh: its process group, rank,
    the number of ranks and the device it computes on."""

    group: object
    rank: int
    size: int
    device: torch.device
    backend: str

    @property
    def axis(self) -> str:
        """The mesh axis its collectives run over (the JAX package's "p"):
        the 1-D mesh's one group."""
        return "p"

    @property
    def staged(self) -> bool:
        """gloo with CUDA tensors: collectives copy through host buffers."""
        return self.backend == "gloo" and self.device.type == "cuda"


def make_mesh(num_devices: Optional[int] = None, device=None, backend: Optional[str] = None,
              init_method: Optional[str] = None, rank: Optional[int] = None) -> Mesh:
    """Join the process group of this process (or start it, given
    ``init_method`` and ``rank``) as a mesh of ``num_devices`` ranks.

    ``device``: "cpu" runs the plain versions of the kernels on gloo;
    None runs on the card: NCCL with rank r on ``cuda:r`` (raises with
    fewer cards than ranks), or with ``backend="gloo"`` every rank on the
    current card. A rank with no card raises unless the CPU was asked for.
    """
    if not dist.is_initialized():
        if init_method is None or rank is None or num_devices is None:
            raise RuntimeError("no process group: start the ranks with "
                               "sphexa_torch.parallel.mesh.spawn, or pass init_method and rank")
        dev = resolve_device(device)
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        if backend == "nccl" and dev.type == "cuda":
            count = torch.cuda.device_count()
            if count < num_devices:
                raise RuntimeError(f"NCCL needs one card per rank: {num_devices} ranks, "
                                   f"{count} cards (gloo lets ranks share a card)")
            torch.cuda.set_device(rank)
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=num_devices)
    size = dist.get_world_size()
    if num_devices is not None and num_devices != size:
        raise ValueError(f"requested {num_devices} ranks, the process group has {size}")
    backend = dist.get_backend()
    dev = resolve_device(device)
    if dev.type == "cuda" and backend == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(group=dist.group.WORLD, rank=dist.get_rank(), size=size, device=dev,
                backend=backend)


def shard_state(state, mesh: Mesh, n: Optional[int] = None):
    """This rank's slab of a whole state: rows [k S, (k + 1) S) of every
    per-particle tensor, scalars as they are; the count must divide by the
    number of ranks (pad or trim the state first). ``n``: the particle
    count, for a dataclass of tensors without one (the chemistry)."""
    n = state.n if n is None else n
    if n % mesh.size:
        raise ValueError(f"particle count {n} not divisible by mesh size {mesh.size}; "
                         "pad the state first")
    S = n // mesh.size
    lo = mesh.rank * S

    def slab(a):
        if a.dim() >= 1 and a.shape[0] == n:
            return a[lo:lo + S].contiguous().to(mesh.device)
        return a.to(mesh.device)

    return dataclasses.replace(state, **{f.name: slab(getattr(state, f.name))
                                         for f in dataclasses.fields(state)})


# ---------------------------------------------------------------------------
# collectives: every one this package issues goes through these, so that
# the staged (gloo + CUDA) backend copies through host buffers in one place
# ---------------------------------------------------------------------------


def _host(t: torch.Tensor) -> torch.Tensor:
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t)
    return buf


def all_gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """(P, *t.shape): every rank's ``t``, in rank order."""
    with costs.collective(mesh, "all_gather", t) as c:
        src = _host(t) if mesh.staged else t.contiguous()
        out = [torch.empty_like(src) for _ in range(mesh.size)]
        dist.all_gather(out, src, group=mesh.group)
        g = torch.stack(out)
        return c.done(g.to(mesh.device) if mesh.staged else g)


def all_reduce_sum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Sum over ranks of an integer tensor (exact in any order)."""
    if t.is_floating_point():
        raise ValueError("all_reduce_sum is for integer tensors: float sums go through "
                         "reduce_scalars, in rank order")
    with costs.collective(mesh, "all_reduce", t, reduce="sum") as c:
        buf = _host(t) if mesh.staged else t.clone()
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
        return c.done(buf.to(mesh.device) if mesh.staged else buf)


def all_to_all_rows(mesh: Mesh, send: torch.Tensor, send_counts: Sequence[int],
                    recv_counts: Sequence[int]) -> torch.Tensor:
    """Rows of ``send`` in rank-order pieces of ``send_counts`` to each
    rank; returns the received rows, src-rank order (one all_to_all)."""
    with costs.collective(mesh, "all_to_all", send) as c:
        send = send.contiguous()
        src = _host(send) if mesh.staged else send
        out = torch.empty((sum(recv_counts),) + tuple(send.shape[1:]), dtype=send.dtype,
                          pin_memory=mesh.staged, device="cpu" if mesh.staged else send.device)
        dist.all_to_all_single(out, src, output_split_sizes=list(recv_counts),
                               input_split_sizes=list(send_counts), group=mesh.group)
        return c.done(out.to(mesh.device) if mesh.staged else out)


def exchange_rounds(mesh: Mesh, sends: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sparse exchange's P - 1 rounds, issued as one batch: round r
    (``sends[r - 1]``) goes to rank (k + r) % P and comes from (k - r) % P
    in a buffer of the same shape (the JAX package's ppermute by distance)."""
    k, P = mesh.rank, mesh.size
    with costs.collective(mesh, "p2p", *sends) as c:
        srcs = [_host(s) if mesh.staged else s.contiguous() for s in sends]
        recvs = [torch.empty_like(s) for s in srcs]
        ops = []
        for r, (s, o) in enumerate(zip(srcs, recvs), start=1):
            ops.append(dist.P2POp(dist.isend, s, (k + r) % P, group=mesh.group))
            ops.append(dist.P2POp(dist.irecv, o, (k - r) % P, group=mesh.group))
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        got = [o.to(mesh.device) for o in recvs] if mesh.staged else recvs
        return c.done_p2p([((k + r) % P, s) for r, s in enumerate(sends, start=1)],
                          [((k - r) % P, o) for r, o in enumerate(got, start=1)])


def gather_rows(mesh: Mesh, t: torch.Tensor, dst: int = 0) -> Optional[torch.Tensor]:
    """Every rank's rows of ``t`` concatenated in rank order on rank
    ``dst`` (one gather; None on the other ranks). For output only: the
    steps never gather."""
    with costs.collective(mesh, "gather", t) as c:
        src = _host(t) if mesh.staged else t.contiguous()
        out = [torch.empty_like(src) for _ in range(mesh.size)] if mesh.rank == dst else None
        dist.gather(src, out, dst=dst, group=mesh.group)
        if out is None:
            return c.done(None, peer=dst)
        g = torch.cat(out)
        return c.done(g.to(mesh.device) if mesh.staged else g, peer=dst)


def broadcast_flag(mesh: Mesh, flag: bool, src: int = 0) -> bool:
    """Rank ``src``'s ``flag`` on every rank (a decision taken on one
    rank's clock, such as a wall-clock limit)."""
    dev = mesh.device if mesh.backend == "nccl" else torch.device("cpu")
    t = torch.tensor([1 if flag else 0], dtype=torch.int32, device=dev)
    dist.broadcast(t, src=src, group=mesh.group)
    return bool(t.item())


def reduce_scalars(mesh: Mesh, sums: Sequence[torch.Tensor] = (),
                   maxes: Sequence[torch.Tensor] = (), mins: Sequence[torch.Tensor] = ()):
    """Replicated reductions of small per-rank tensors in one all_gather:
    ``sums`` added in rank order 0..P-1 (the same float64 rounding on
    every rank), ``maxes`` and ``mins`` elementwise. Each result keeps its
    input's shape and dtype; values travel as float64 (integers exact up
    to 2^53). Returns (sums, maxes, mins) as lists."""
    groups = (list(sums), list(maxes), list(mins))
    flat = [t.reshape(-1).to(torch.float64) for g in groups for t in g]
    g = all_gather(mesh, torch.cat(flat))  # (P, K)
    acc_sum = g[0].clone()
    for r in range(1, mesh.size):
        acc_sum = acc_sum + g[r]
    acc = (acc_sum, g.amax(dim=0), g.amin(dim=0))
    out, off = ([], [], []), 0
    for gi, grp in enumerate(groups):
        for t in grp:
            k = t.numel()
            out[gi].append(acc[gi][off:off + k].reshape(t.shape).to(t.dtype))
            off += k
    return out


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def _rank_main(rank: int, fn: Callable, nprocs: int, init_method: str, device,
               backend: Optional[str], threads: Optional[int], workdir: str, args: tuple):
    if threads is not None:
        torch.set_num_threads(threads)
    mesh = make_mesh(nprocs, device=device, backend=backend, init_method=init_method,
                     rank=rank)
    try:
        out = fn(mesh, *args)
        with open(os.path.join(workdir, f"result-{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, args: tuple = (), workdir: str = ".", device=None,
          backend: Optional[str] = None, threads: Optional[int] = None,
          timeout: float = 600.0) -> list:
    """Run ``fn(mesh, *args)`` on ``nprocs`` ranks, each a process of its
    own (torch.multiprocessing, spawn; ``fn`` must be importable), joined
    by a ``file://`` rendezvous in ``workdir``. ``device``/``backend`` as
    in ``make_mesh``; ``threads``: torch's intra-op threads in each rank.
    Returns each rank's return value, in rank order. A rank that raises or
    dies, or a run past ``timeout`` seconds, stops every rank and raises."""
    import torch.multiprocessing as mp

    os.makedirs(workdir, exist_ok=True)
    tag = uuid.uuid4().hex
    rdzv = os.path.join(os.path.abspath(workdir), f"rdzv-{tag}")
    sub = os.path.join(os.path.abspath(workdir), f"ranks-{tag}")
    os.makedirs(sub)
    ctx = mp.start_processes(
        _rank_main, args=(fn, nprocs, f"file://{rdzv}", device, backend, threads, sub, args),
        nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, min(1.0, deadline - time.monotonic()))):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{nprocs} ranks still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
        for p in ctx.processes:
            p.join(10)
            if p.is_alive():
                p.kill()
    out = []
    for r in range(nprocs):
        with open(os.path.join(sub, f"result-{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


# ---------------------------------------------------------------------------
# the sharded step
# ---------------------------------------------------------------------------

def make_sharded_step(mesh: Mesh, cfg, step_fn=None, halo_window: int = 0,
                      halo_cells: Sequence[int] = (), grav_cells: Sequence[int] = (),
                      aux_cfg=None):
    """The step of this rank's slab (the JAX package's make_sharded_step):
    ``stepper(state, box, gtree=None, aux=None)`` runs ``step_fn`` (std,
    the default, VE, turb-ve, std-cooling, N-body, or the std and VE block
    time steps with ``cfg.dt_bins``) with ``cfg`` bound to the mesh and
    the halo exchange's sizes: ``halo_cells`` (P - 1 per-distance row
    caps) selects the sparse exchange, else ``halo_window`` rows per peer
    (0: whole slabs); the N-body step has no SPH halo and ignores both.
    The steps stream (no lists). With self-gravity (``cfg.gravity``)
    ``gtree`` is the replicated tree, and ``grav_cells`` (P - 1
    per-distance caps, ``sizing.device_gravity_halo``) selects the
    MAC-sized sparse near-field serve, else whole slabs. The aux steps
    take their slot's state as ``aux`` (turb-ve the replicated
    TurbulenceState, std-cooling its chemistry slab, the block time steps
    their BlockDtState slab), turb-ve and std-cooling their static config
    as ``aux_cfg``, and return the advanced aux fourth. ``stepper.step_sim(
    sim, gtree=None)`` advances a SimState carry.

    The config's backend picks the sharded stages: "pallas" the engine's
    (K1's and K12's jdata forms), "xla" the gather backend's (the search
    of the global groups that meet the slab, the gather ops and near
    field on the same j-buffers, no kernel: what the JAX package's GSPMD
    program computes, each row's first ngmax neighbours). The halo sizes
    must be those of the backend (``sizing.halo_sizes(backend=)``): the
    gather halo serves whole window cells."""
    from sphexa_torch import propagator as prop

    step_fn = prop._step_hydro_std if step_fn is None else step_fn
    blockdt = (prop._step_hydro_std_blockdt, prop._step_hydro_ve_blockdt)
    known = (prop._step_hydro_std, prop._step_hydro_ve, prop._step_turb_ve,
             prop._step_hydro_std_cooling, prop._step_nbody) + blockdt
    if step_fn not in known:
        raise ValueError(f"{getattr(step_fn, '__name__', step_fn)} is no step function of "
                         "sphexa_torch.propagator")
    if (step_fn in blockdt) != (cfg.dt_bins is not None):
        raise ValueError("the block-time-step functions, and only they, take cfg.dt_bins")
    for name, caps in (("halo_cells", halo_cells), ("grav_cells", grav_cells)):
        if caps and len(caps) != mesh.size - 1:
            raise ValueError(f"{name} needs P-1={mesh.size - 1} caps, got {len(caps)}")
    cfg = dataclasses.replace(cfg, mesh=mesh, halo_window=int(halo_window),
                              halo_cells=tuple(int(c) for c in halo_cells),
                              grav_cells=tuple(int(c) for c in grav_cells), list_slot_cap=0)
    with_cfg = step_fn in prop.STEP_AUX_CFG
    with_aux = step_fn in prop.STEP_AUX_SLOT

    def stepper(state, box, gtree=None, aux=None):
        if with_cfg:
            return step_fn(state, box, cfg, gtree, aux, aux_cfg)
        if with_aux:
            return step_fn(state, box, cfg, gtree, aux)
        return step_fn(state, box, cfg, gtree)

    def step_sim(sim, gtree=None):
        return prop.step_sim_state(step_fn, sim, cfg, gtree, aux_cfg)

    stepper.cfg = cfg
    stepper.step_sim = step_sim
    return stepper
