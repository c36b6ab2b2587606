"""The SPMD analysis of the port's audit (the JAX package's
devtools/audit/spmd.py), shared by JXA201-JXA204 and the ``preflight``
table.

A torch entry has no SPMD program to walk: a sharded entry is P rank
processes, and its record is one ``Tally`` a rank (core.run_sharded). One
``SpmdReport`` an entry is built from those records:

- **the collectives of each rank** (``Tally.collectives``: the mesh's
  wrappers and any c10d op dispatched outside them, in issue order), and
  what JXA201 reads off them: every rank issues the same collectives in
  the same order, (op, group, dtype, site) for (op, group, dtype, site);
  the collectives that need one shape on every rank (all_reduce,
  all_gather, broadcast, reduce, gather) have it; each send of a P2P batch
  meets its peer's receive of the same bytes. torch issues collectives in
  program order, so a race is not the hazard it is under XLA: a
  rank-dependent order is. Two same-shape all_reduces issued in an order
  that depends on the rank complete on gloo with cross-wired payloads.
- **a liveness sweep over each rank's rows**: a buffer (a tensor, or the
  base its views share) is live from the first row that names it to the
  last, a kernel's outputs from the ``kernel:<name>`` token of their
  launch (the JAX sweep's leaf ``pallas_call``), the run's arguments and
  outputs throughout; the peak over the rows is the **toy peak**. The
  **campaign peak** rescales every extensive buffer (a whole number of the
  rank's slab rows S) by ``(campaign_n / campaign_devices) / S``; the rest
  (cell tables, tree arrays, scalars) stays at its traced size, which
  JXA204's two-point probe holds to growing no faster than N. S is the
  most common leading dimension of the entry's tensor arguments (the
  slab's fields outnumber the tree's and the tables' arrays).
- **replicated particle rows** (JXA203): a collective whose result holds
  the global N rows of a particle field on every rank (an all_gather of a
  slab-shaped operand, an all_reduce or broadcast of an N-row one), its
  bytes at campaign N;
- **the summed bytes that arrive** at each rank through its collectives
  (JXA203's exchange volume, the table's ``exchange``).

The report is cached on the trace per campaign, so that the rules and the
table pay for one sweep an entry.
"""

import collections
import dataclasses
import re
from typing import Dict, List, Optional, Tuple

__all__ = ["SAME_SHAPE_OPS", "Replicated", "RankReport", "SpmdReport", "spmd_report",
           "order_problems", "slab_rows", "liveness", "non_extensive_bytes",
           "format_bytes"]

#: collectives every rank must call with one shape
SAME_SHAPE_OPS = frozenset({"all_reduce", "all_gather", "broadcast", "reduce", "gather"})
#: collectives whose result holds every rank's operand
_REPLICATING = frozenset({"all_gather"})
_GLOBAL = frozenset({"all_reduce", "broadcast"})

_NAME = re.compile(r"\bt(\d+):")


@dataclasses.dataclass(frozen=True)
class Replicated:
    """A collective result holding the global N rows on every rank."""

    rank: int
    op: str
    site: str
    shape: Tuple[int, ...]
    dtype: str
    toy_bytes: int
    campaign_bytes: int


@dataclasses.dataclass
class RankReport:
    rank: int
    collectives: list
    toy_peak_bytes: int
    campaign_peak_bytes: Optional[int]
    exchange_bytes: int
    max_allocated: Optional[int] = None


@dataclasses.dataclass
class SpmdReport:
    mesh_size: int                       # ranks recorded (1: one device)
    ranks: List[RankReport]
    order_problems: List[str]            # JXA201's findings, each a sentence
    toy_peak_bytes: int                  # the largest rank's
    campaign_peak_bytes: Optional[int]   # rescaled; None on one device
    toy_slab_rows: int                   # S
    campaign_ratio: Optional[float]
    replicated: List[Replicated]
    collective_out_bytes: int            # the largest rank's summed arrivals
    n_global: int                        # S x P

    @property
    def collectives(self) -> list:
        """Rank 0's collectives."""
        return self.ranks[0].collectives if self.ranks else []


def format_bytes(b: Optional[int]) -> str:
    if b is None:
        return "-"
    if b >= 1 << 30:
        return f"{b / (1 << 30):.2f}GiB"
    if b >= 1 << 20:
        return f"{b / (1 << 20):.2f}MiB"
    if b >= 1 << 10:
        return f"{b / (1 << 10):.1f}KiB"
    return f"{b}B"


def slab_rows(args) -> int:
    """S: the most common leading dimension of the tensors in ``args``
    (the larger on a tie; 0 without one)."""
    from sphexa_torch.devtools.audit.statecheck import flatten

    dims = collections.Counter()
    for _p, leaf in flatten(args):
        shape = getattr(leaf, "shape", None)
        if shape is not None and len(shape) >= 1 and hasattr(leaf, "dtype"):
            dims[int(shape[0])] += 1
    if not dims:
        return 0
    return max(dims, key=lambda d: (dims[d], d))


def _intervals(tally) -> Tuple[Dict[int, int], Dict[int, int], int]:
    """(first row, last row, rows) of every buffer the record names."""
    first: Dict[int, int] = {}
    last: Dict[int, int] = {}
    for i, row in enumerate(tally.rows):
        for m in _NAME.finditer(row.line):
            idx = int(m.group(1))
            b = tally.tensor_buf[idx]
            born = tally.births.get(idx, i)
            first[b] = min(first.get(b, born), born)
            last[b] = max(last.get(b, i), i)
    end = len(tally.rows)
    for b in set(tally.arg_bufs) | set(tally.out_bufs):
        first[b] = 0
        last[b] = end
    return first, last, end


def _extensive(numel: int, s: int) -> bool:
    return bool(s) and numel >= s and numel % s == 0


def liveness(tally, s: int, ratio: float) -> Tuple[int, int]:
    """(toy peak, campaign peak) bytes over a rank's rows: every buffer
    live from its first row to its last, args and outputs throughout; the
    campaign peak with the extensive buffers rescaled by ``ratio``."""
    first, last, end = _intervals(tally)
    dt = [0] * (end + 2)
    dc = [0] * (end + 2)
    for b, f0 in first.items():
        numel, item = tally.buf_numel[b], tally.buf_itemsize[b]
        bt = numel * item
        bc = int(bt * ratio) if ratio > 1.0 and _extensive(numel, s) else bt
        dt[f0] += bt
        dt[last[b] + 1] -= bt
        dc[f0] += bc
        dc[last[b] + 1] -= bc
    peak_t = peak_c = run_t = run_c = 0
    for p in range(end + 1):
        run_t += dt[p]
        run_c += dc[p]
        peak_t = max(peak_t, run_t)
        peak_c = max(peak_c, run_c)
    return peak_t, peak_c


#: the rows a block of the engines and of the gravity traversal pads to
_BLOCK = 64


def non_extensive_bytes(tally, s: int) -> int:
    """JXA204's class: the summed bytes of the distinct buffers of a run
    that are not a whole number of the slab rows S, of their power-of-two
    padding (capacity-padded working sets) or of the slab padded to whole
    blocks of 64 (the engines' groups, the traversal's (blocks, 64, cap)
    tables): cell tables, tree arrays, work buffers of config sizes."""
    cands = [c for c in (s, 1 << max(int(s) - 1, 0).bit_length() if s else 0,
                         -(-int(s) // _BLOCK) * _BLOCK) if c]
    first, _last, _end = _intervals(tally)
    total = 0
    for b in first:
        numel = tally.buf_numel[b]
        if not any(_extensive(numel, c) for c in cands):
            total += numel * tally.buf_itemsize[b]
    return total


def _key(c) -> Tuple[str, str, str, str]:
    return (c.op, c.group, c.dtype, c.site)


def order_problems(seqs: List[list]) -> List[str]:
    """JXA201's findings over the ranks' collective sequences (rank order)."""
    out: List[str] = []
    if len(seqs) < 2:
        return out
    ref = seqs[0]
    for r, seq in enumerate(seqs[1:], start=1):
        div = next((i for i, (a, b) in enumerate(zip(ref, seq)) if _key(a) != _key(b)), None)
        if div is None and len(ref) != len(seq):
            div = min(len(ref), len(seq))
        if div is not None:
            a = ref[div] if div < len(ref) else None
            b = seq[div] if div < len(seq) else None
            show = (lambda c: "nothing" if c is None
                    else f"{c.op}[{c.group}] {c.dtype}{list(c.shape)} at {c.site}")
            out.append(f"rank {r} issues another collective than rank 0 at #{div}: "
                       f"{show(b)} where rank 0 issues {show(a)}")
            continue
        for i, (a, b) in enumerate(zip(ref, seq)):
            if a.op in SAME_SHAPE_OPS and a.shape != b.shape:
                out.append(f"{a.op} #{i} at {a.site}: rank 0 gives {list(a.shape)}, rank {r} "
                           f"{list(b.shape)} (every rank must give one shape)")
                break
    # each send meets its peer's receive of the same bytes, in order
    sends = collections.defaultdict(list)
    recvs = collections.defaultdict(list)
    for r, seq in enumerate(seqs):
        for c in seq:
            if c.op == "send" and c.peer is not None:
                sends[(r, c.peer)].append((c.nbytes, c.site))
            elif c.op == "recv" and c.peer is not None:
                recvs[(c.peer, r)].append((c.nbytes, c.site))
    for pair in sorted(set(sends) | set(recvs)):
        s = [b for b, _ in sends.get(pair, [])]
        v = [b for b, _ in recvs.get(pair, [])]
        if s != v:
            site = (sends.get(pair) or recvs.get(pair))[0][1]
            out.append(f"rank {pair[0]} sends rank {pair[1]} {s} bytes, rank {pair[1]} "
                       f"receives {v} from it (at {site})")
    return out


def _replicated(rank: int, colls, s: int, n_global: int, campaign_n: int) -> List[Replicated]:
    out = []
    for c in colls:
        lead = int(c.shape[0]) if c.shape else 0
        if (c.op in _REPLICATING and lead == s) or (c.op in _GLOBAL and lead == n_global):
            if n_global <= 1:
                continue
            cb = int(c.nbytes * campaign_n / n_global) if campaign_n else c.nbytes
            out.append(Replicated(rank=rank, op=c.op, site=c.site, shape=tuple(c.shape),
                                  dtype=c.dtype, toy_bytes=c.nbytes, campaign_bytes=cb))
    return out


def spmd_report(trace, ctx) -> SpmdReport:
    """The SPMD report of an entry's trace under an AuditContext (its
    campaign); cached on the trace."""
    key = (ctx.campaign_n, ctx.campaign_devices)
    cached = getattr(trace, "_spmd", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    views = trace.ranks
    P = len(views) if trace.sharded else 1
    s = slab_rows(views[0].case.args)
    n_global = s * P
    ratio = None
    if trace.sharded and s:
        ratio = (ctx.campaign_n / max(ctx.campaign_devices, 1)) / s
    ranks, replicated = [], []
    for v in views:
        t = v.tally
        toy, camp = liveness(t, s, ratio or 0.0)
        colls = list(t.collectives)
        ranks.append(RankReport(rank=v.rank, collectives=colls, toy_peak_bytes=toy,
                                campaign_peak_bytes=camp if ratio else None,
                                exchange_bytes=sum(c.nbytes for c in colls if c.op != "send"),
                                max_allocated=v.max_allocated))
        if trace.sharded:
            replicated += _replicated(v.rank, colls, s, n_global, ctx.campaign_n)
    report = SpmdReport(
        mesh_size=P, ranks=ranks,
        order_problems=order_problems([r.collectives for r in ranks]),
        toy_peak_bytes=max(r.toy_peak_bytes for r in ranks),
        campaign_peak_bytes=(max(r.campaign_peak_bytes for r in ranks) if ratio else None),
        toy_slab_rows=s, campaign_ratio=ratio, replicated=replicated,
        collective_out_bytes=max(r.exchange_bytes for r in ranks), n_global=n_global)
    trace._spmd = (key, report)
    return report
