"""Shared control-flow-graph decomposition over the packed ISA image
(a copy of the reference's framework-free ``repro.core.cfg``).

Every tier of the stack needs the same structural view of a program:

* the basic-block tier (``blockc``) replays one CUDA graph per block
  dispatch,
* the superblock path simulator folds the executed block sequence,
* the reference's static analyzer (``analysis``) runs dataflow over
  the block graph.

The decomposition used to live privately in ``blockc._decompose``; it is
extracted here so the analyzer and the compiler agree bit-for-bit on
block boundaries.  The eGPU ISA has *no data-dependent branches* — every
JMP/JSR/LOOP target and every INIT trip count is an immediate — so this
graph is exact, not an approximation: the runtime path is one walk of it.

Edge kinds
----------
``fall``       straight-line fall-through (including artificial
               ``MAX_BLOCK`` splits and the not-taken LOOP exit)
``jump``       unconditional JMP
``call``       JSR to its (immediate) target
``return``     RTS to a return site (the instruction after some JSR);
               when the analyzer cannot prove which, every return site
               is a conservative successor
``loop_back``  LOOP back-edge to its (immediate) target
``loop_exit``  LOOP fall-through when the hardware loop counter hits 0

A pc leaving ``[0, n)`` halts the machine (the padded image tail is all
STOP), so blocks with no successors are genuine exits, and an
out-of-image branch target is a structural defect recorded in
``ProgramCFG.bad_targets`` rather than an edge.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .executor import _PF_IMM, _PF_OP
from .isa import Op

#: trace-size bound: longer straight-line runs are split with an
#: artificial fall-through (keeps per-block captures bounded)
MAX_BLOCK = 192

#: superblock trace budget — total instructions traced per compile
#: (straight-line runs plus each repeat body once); the generalization
#: of the per-block ``MAX_BLOCK`` bound to whole-path traces.  Programs
#: over budget fall back to the basic-block driver.
MAX_TRACE = 4096

#: sequencer ops that end a basic block (IF/ELSE/ENDIF are *predicate*
#: ops — they mask threads but never move the PC, so they trace inline)
SEQ_TERM = (int(Op.JMP), int(Op.JSR), int(Op.RTS), int(Op.LOOP),
            int(Op.STOP))

#: branch ops whose immediate is a program-counter target
TARGET_OPS = (int(Op.JMP), int(Op.JSR), int(Op.LOOP))


def decompose(packed: np.ndarray, n: int,
              max_block: int = MAX_BLOCK) -> list[tuple[int, int]]:
    """Split ``[0, n)`` into basic blocks ``(start, end)`` (end exclusive,
    terminator included).  Leaders: instruction 0, every in-range
    JMP/JSR/LOOP target, and every instruction after a sequencer op
    (fall-throughs and JSR return addresses)."""
    ops = packed[:n, _PF_OP]
    imms = packed[:n, _PF_IMM]
    leaders = {0}
    for i in range(n):
        o = int(ops[i])
        if o in TARGET_OPS:
            t = int(imms[i])
            if 0 <= t < n:
                leaders.add(t)
        if o in SEQ_TERM and i + 1 < n:
            leaders.add(i + 1)
    starts = sorted(leaders)
    blocks: list[tuple[int, int]] = []
    for s, e in zip(starts, starts[1:] + [n]):
        while e - s > max_block:
            blocks.append((s, s + max_block))
            s += max_block
        blocks.append((s, e))
    return blocks


@dataclass
class ProgramCFG:
    """Basic blocks plus typed edges over a packed program image."""

    n: int
    blocks: list[tuple[int, int]]
    #: per-block list of ``(successor_block_index, edge_kind)``
    succs: list[list[tuple[int, str]]]
    #: per-block predecessor block indices (kind-blind)
    preds: list[list[int]]
    #: pc -> index of the block containing it
    block_of: dict[int, int] = field(repr=False)
    #: pcs immediately after a JSR (conservative RTS successors)
    return_sites: list[int]
    #: ``(pc, op, target)`` for branch immediates outside ``[0, n)``
    bad_targets: list[tuple[int, int, int]]

    def reachable(self, entry: int = 0) -> set[int]:
        """Block indices reachable from the block containing ``entry``."""
        seen: set[int] = set()
        work = [self.block_of[entry]] if entry in self.block_of else []
        while work:
            b = work.pop()
            if b in seen:
                continue
            seen.add(b)
            work.extend(s for s, _ in self.succs[b] if s not in seen)
        return seen


def build_cfg(packed: np.ndarray, n: int,
              max_block: int = MAX_BLOCK) -> ProgramCFG:
    """Build the typed block graph for ``packed[:n]``.

    RTS blocks get a ``return`` edge to *every* return site — callers
    that can prove the return address (the analyzer's call-stack
    dataflow usually can) refine this themselves.
    """
    blocks = decompose(packed, n, max_block)
    block_of = {}
    for bi, (s, e) in enumerate(blocks):
        for pc in range(s, e):
            block_of[pc] = bi
    ops = packed[:n, _PF_OP]
    imms = packed[:n, _PF_IMM]
    return_sites = [i + 1 for i in range(n)
                    if int(ops[i]) == int(Op.JSR) and i + 1 < n]
    bad_targets = []
    succs: list[list[tuple[int, str]]] = []
    for bi, (s, e) in enumerate(blocks):
        out: list[tuple[int, str]] = []
        term = int(ops[e - 1])
        tgt = int(imms[e - 1])
        if term == int(Op.STOP):
            pass                                   # halt: no successors
        elif term == int(Op.JMP):
            if 0 <= tgt < n:
                out.append((block_of[tgt], "jump"))
            else:
                bad_targets.append((e - 1, term, tgt))
        elif term == int(Op.JSR):
            if 0 <= tgt < n:
                out.append((block_of[tgt], "call"))
            else:
                bad_targets.append((e - 1, term, tgt))
        elif term == int(Op.RTS):
            out.extend((block_of[r], "return") for r in return_sites)
        elif term == int(Op.LOOP):
            if 0 <= tgt < n:
                out.append((block_of[tgt], "loop_back"))
            else:
                bad_targets.append((e - 1, term, tgt))
            if e < n:
                out.append((block_of[e], "loop_exit"))
        else:                                      # plain fall-through
            if e < n:
                out.append((block_of[e], "fall"))
        succs.append(out)
    preds: list[list[int]] = [[] for _ in blocks]
    for bi, out in enumerate(succs):
        for sb, _ in out:
            if bi not in preds[sb]:
                preds[sb].append(bi)
    return ProgramCFG(n=n, blocks=blocks, succs=succs, preds=preds,
                      block_of=block_of, return_sites=return_sites,
                      bad_targets=bad_targets)


def summary(packed: np.ndarray, n: int) -> dict[str, float]:
    """Cheap structural facts for ``TierPolicy`` static features.

    Pure graph shape — no dataflow — so it is safe to compute on the
    compile path for every program."""
    g = build_cfg(packed, n)
    ops = packed[:n, _PF_OP]
    n_loops = int(np.sum(ops == int(Op.LOOP)))
    n_calls = int(np.sum(ops == int(Op.JSR)))
    reach = g.reachable(0)
    n_edges = sum(len(s) for s in g.succs)
    return {
        "cfg_blocks": float(len(g.blocks)),
        "cfg_edges": float(n_edges),
        "cfg_loops": float(n_loops),
        "cfg_calls": float(n_calls),
        "cfg_reachable_frac": float(len(reach) / max(1, len(g.blocks))),
        "cfg_straightline": float(n_loops == 0 and n_calls == 0
                                  and int(np.sum(ops == int(Op.JMP))) == 0),
    }
