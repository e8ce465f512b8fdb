"""The eGPU SIMT executor on PyTorch: host sequencer, device data path.

The eGPU has no data-dependent branches.  Every control decision comes
from an immediate, an INIT count or the runtime thread count: the PC and
the call/loop stacks (JMP/JSR/RTS/LOOP/INIT/STOP), the issue cycles, the
RAW hazard rows and the Fig. 6 counters.  So the port keeps all of them
on the host in Python ints (:func:`sequence`, as the reference's
``blockc._simulate`` does), and the device runs only the data path, one
instruction per step (:func:`make_step`): operand gather, the value,
the masked register write-back, the predicate stacks and the STO
scatter.  The whole instruction trace goes to the device once, before
the loop, so on CUDA the step loop never waits for the card (no
``.item()``, no ``.cpu()``, no host-to-device copy).

One driver serves one core (:func:`run_program`) and a lock-step batch
of cores (``repro_torch.fleet.engine.fleet_run``): the batch axis is
written out, each core carries its own program, thread count, TDX grid
and shared memory, and a core whose program has ended executes NOPs,
which change nothing, so its state stays frozen leaf for leaf.

Every leaf, hazard rows and counters included, is bit-identical to the
reference's ``repro.core.executor.run_program``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import isa, semantics
from .assembler import ProgramImage
from .config import EGPUConfig
from .isa import Op, Typ
from .machine import (MachineState, init_numpy, resolve_device,
                      state_to_numpy)
from ..obs import trace as obs_trace

# table columns
(_TC_SCALAR, _TC_READS_RA, _TC_READS_RB, _TC_READS_RD, _TC_WRITES_RD,
 _TC_LAT, _TC_CLS, _TC_PER_WF0) = range(8)          # per_wf spans cols 7..10
_TC_WRITES_PRED = 11

# program-image columns (see pad_image)
_PF_OP, _PF_TYP, _PF_RD, _PF_RA, _PF_RB, _PF_IMM, _PF_TSC = range(7)
PROG_FIELDS = ("op", "typ", "rd", "ra", "rb", "imm", "tsc")

_PAD = 64  # programs are padded to a multiple of this (the reference's grid)

_IF_RANGE = range(int(Op.IF_EQ), int(Op.IF_NZ) + 1)
_EXT0 = (int(Op.DOT), int(Op.SUM))
_NOP = int(Op.NOP)


def tables_np(cfg: EGPUConfig) -> np.ndarray:
    """The per-opcode metadata table, as the reference's ``tables_np``."""
    n = isa.NUM_OPCODES
    t = np.zeros((n, 12), np.int32)
    t[:, _TC_PER_WF0:_TC_PER_WF0 + 4] = 1
    from . import cost as _cost

    for op in Op:
        t[op, _TC_SCALAR] = op in isa.SCALAR_OPS
        t[op, _TC_READS_RA] = op in isa.READS_RA
        t[op, _TC_READS_RB] = op in isa.READS_RB
        t[op, _TC_READS_RD] = op in isa.READS_RD
        t[op, _TC_WRITES_RD] = op in isa.REG_WRITE_OPS
        t[op, _TC_LAT] = _cost.result_latency(op, cfg)
        t[op, _TC_CLS] = isa.OP_CLASS[op]
        t[op, _TC_WRITES_PRED] = op in isa.PRED_WRITE_OPS
        for wc in range(4):
            width = isa.WIDTH_LANES[wc]
            if op == Op.LOD:
                t[op, _TC_PER_WF0 + wc] = -(-width // cfg.cost.sp_read_ports)
            elif op == Op.STO:
                t[op, _TC_PER_WF0 + wc] = -(-width // cfg.write_ports)
    return t


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def padded_length(n: int) -> int:
    """Instruction count rounded up to the shared ``_PAD`` grid."""
    return n + (-n) % _PAD


def pad_image(image: ProgramImage, prog_len: int | None = None):
    """Pack a program into a ``(padded_len, 7)`` int32 array of decoded
    fields (column order :data:`PROG_FIELDS`), padded with STOP rows;
    the seam with the reference, whose ``pad_image`` gives the same
    array.  Returns ``(packed, padded_len)``."""
    n = image.n
    length = prog_len if prog_len is not None else padded_length(n)
    if length < n:
        raise ValueError(f"prog_len {length} < program length {n}")
    packed = np.zeros((length, 7), np.int32)
    packed[n:, _PF_OP] = int(Op.STOP)
    for col, field in enumerate(PROG_FIELDS):
        packed[:n, col] = getattr(image, field)
    return packed, length


def tsc_masks(cfg: EGPUConfig, threads_active: int) -> np.ndarray:
    """``(16, T)`` bool: the TSC thread mask for each 4-bit coding at this
    runtime thread count (width lanes x depth wavefronts x threads)."""
    T = cfg.max_threads
    tid = np.arange(T)
    lane, wf = tid % cfg.num_sps, tid // cfg.num_sps
    w_rt = _cdiv(threads_active, cfg.num_sps)
    wfs = (1, w_rt, max(1, _cdiv(w_rt, 2)), max(1, _cdiv(w_rt, 4)))
    out = np.zeros((16, T), np.bool_)
    for tsc in range(16):
        out[tsc] = ((lane < isa.WIDTH_LANES[(tsc >> 2) & 3])
                    & (wf < wfs[tsc & 3]) & (tid < threads_active))
    return out


# ---------------------------------------------------------------------------
# Host sequencer: PC, stacks, cycles, hazards and counters in Python ints
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HostCore:
    """The control state of one core, all Python ints (the leaves that
    the device never needs)."""

    pc: int
    lctr: list
    lsp: int
    cstack: list
    csp: int
    cycles: int
    steps: int
    halted: bool
    threads_active: int
    tdx_dim: int
    stat_cycles: list
    stat_instrs: list
    hazard: list
    hazard_violations: int

    @classmethod
    def from_leaves(cls, lv: dict) -> "HostCore":
        return cls(pc=int(lv["pc"]), lctr=[int(x) for x in lv["lctr"]],
                   lsp=int(lv["lsp"]), cstack=[int(x) for x in lv["cstack"]],
                   csp=int(lv["csp"]), cycles=int(lv["cycles"]),
                   steps=int(lv["steps"]), halted=bool(lv["halted"]),
                   threads_active=int(lv["threads_active"]),
                   tdx_dim=int(lv["tdx_dim"]),
                   stat_cycles=[int(x) for x in lv["stat_cycles"]],
                   stat_instrs=[int(x) for x in lv["stat_instrs"]],
                   hazard=[[int(x) for x in r] for r in lv["hazard"]],
                   hazard_violations=int(lv["hazard_violations"]))

    def leaves(self) -> dict:
        i32 = lambda v: np.asarray(v, np.int32)
        return dict(pc=i32(self.pc), lctr=i32(self.lctr), lsp=i32(self.lsp),
                    cstack=i32(self.cstack), csp=i32(self.csp),
                    cycles=i32(self.cycles), steps=i32(self.steps),
                    halted=np.asarray(self.halted, np.bool_),
                    threads_active=i32(self.threads_active),
                    tdx_dim=i32(self.tdx_dim),
                    stat_cycles=i32(self.stat_cycles),
                    stat_instrs=i32(self.stat_instrs),
                    hazard=i32(self.hazard),
                    hazard_violations=i32(self.hazard_violations))


def sequence(packed: np.ndarray, prog_len: int, cfg: EGPUConfig,
             core: HostCore, validate: bool = True) -> np.ndarray:
    """Run one core's control flow to completion on the host, updating
    ``core`` in place exactly as the reference's step does; returns the
    PCs of the instructions executed, in order.  Stops at ``STOP``,
    ``cfg.max_steps`` or a PC outside ``[0, prog_len)`` (the reference's
    ``running``)."""
    tab = tables_np(cfg).tolist()
    rows = packed.tolist()
    R = cfg.regs_per_thread
    w_rt = _cdiv(core.threads_active, cfg.num_sps)
    wfs_of = (1, w_rt, max(1, _cdiv(w_rt, 2)), max(1, _cdiv(w_rt, 4)))
    pred_reads_all = cfg.has_predicates
    LOD, STO = int(Op.LOD), int(Op.STO)
    JMP, JSR, RTS = int(Op.JMP), int(Op.JSR), int(Op.RTS)
    LOOP, INIT, STOP = int(Op.LOOP), int(Op.INIT), int(Op.STOP)
    hz = core.hazard
    pcs = []
    c = core
    while (not c.halted and c.steps < cfg.max_steps
           and 0 <= c.pc < prog_len):
        pc = c.pc
        op, _typ, rd, ra, rb, imm, tsc = rows[pc]
        pcs.append(pc)
        t = tab[op]
        scalar = t[_TC_SCALAR] == 1
        wfs = wfs_of[tsc & 3]
        per_wf = t[_TC_PER_WF0 + ((tsc >> 2) & 3)]
        issue = 1 if scalar else per_wf * wfs
        if validate:
            flags = (t[_TC_READS_RA], t[_TC_READS_RB], t[_TC_READS_RD],
                     op == LOD, pred_reads_all and not scalar)
            need = -(1 << 30)
            for row, fl in zip((hz[ra], hz[rb], hz[rd], hz[R], hz[R + 1]),
                               flags):
                if fl:
                    p_start, p_per_wf, p_wfs, p_lat = row
                    k = min(p_wfs, wfs) - 1 if p_per_wf > per_wf else 0
                    need = max(need, p_start + p_per_wf * (k + 1) - 1
                               + p_lat - per_wf * k)
            if (not scalar or op == LOD) and need > c.cycles:
                c.hazard_violations += 1
            new_row = [c.cycles, per_wf, wfs, t[_TC_LAT]]
            if t[_TC_WRITES_RD]:
                hz[rd] = list(new_row)
            if op == STO:
                hz[R] = list(new_row)
            if t[_TC_WRITES_PRED]:
                hz[R + 1] = list(new_row)
            c.stat_cycles[t[_TC_CLS]] += issue
            c.stat_instrs[t[_TC_CLS]] += 1
        nxt = pc + 1
        if op == JMP:
            nxt = imm
        elif op == JSR:
            c.csp = semantics.call_push(c.cstack, c.csp, pc + 1)
            nxt = imm
        elif op == RTS:
            nxt = semantics.call_top(c.cstack, c.csp)
            c.csp -= 1
        elif op == LOOP:
            taken, c.lsp = semantics.loop_step(c.lctr, c.lsp)
            if taken:
                nxt = imm
        elif op == INIT:
            c.lsp = semantics.loop_init(c.lctr, c.lsp, imm)
        elif op == STOP:
            c.halted = True
        c.cycles += issue
        c.steps += 1
        c.pc = nxt
    return np.asarray(pcs, np.int64)


# ---------------------------------------------------------------------------
# Device data path
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DeviceState:
    """The leaves the data path changes, batched: ``regs (B, T, R)``,
    ``shared (B, S + 1)`` (the last slot drops stores), ``pstack
    (B, T, D)``, ``pdepth (B, T)``; updated in place."""

    regs: torch.Tensor
    shared: torch.Tensor
    pstack: torch.Tensor
    pdepth: torch.Tensor


def _gate(m: torch.Tensor, on) -> torch.Tensor:
    """Mask ``m`` ``(B, T)`` limited to the cores that run the op: ``on``
    ``(B, 1)``, or ``None`` when every core does."""
    return m if on is None else m & on


def _pick(on, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """``new`` for the cores that run the op, ``old`` for the others
    (``on`` as in :func:`_gate`; broadcast over trailing axes)."""
    if on is None:
        return new
    return torch.where(on.reshape(on.shape + (1,) * (new.dim() - 2)),
                       new, old)


def make_step(cfg: EGPUConfig, masks: torch.Tensor, tdx: list,
              device: torch.device):
    """Build the data path of one instruction step over a batch of cores.

    ``masks`` is the ``(B, 16, T)`` TSC mask table (:func:`tsc_masks` per
    core), ``tdx`` the cores' TDX grid widths.  Returns ``step(ds, tr,
    ops, host_row)``: ``tr`` is this step's ``(B, 7)`` int64 trace rows
    on the device (a core not executing has a NOP row), ``ops`` the
    distinct opcodes executed this step (a Python tuple, NOPs left out)
    and ``host_row`` the same row as Python ints when ``B == 1``.
    The predicate mask is cached between steps and rebuilt only after a
    step that changes the predicate stacks.

    One core takes the row's fields from ``host_row``: its operands are
    views of the register file and the value functions fold ``signed``
    and ``imm`` as constants, which issues fewer ops a step than the
    batch's gathers (about a quarter less wall time on the paper suite,
    PERF.md).  Everything after operand fetch and before the register
    write is shared; ``on(o)`` is ``None`` for one core, which executes
    every op of ``ops``.
    """
    B, _, T = masks.shape
    S = cfg.shared_words
    D = max(1, cfg.predicate_levels)
    tab = tables_np(cfg)
    writes_rd = tab[:, _TC_WRITES_RD].astype(bool)
    tid = torch.arange(T, dtype=torch.int32, device=device)
    is_t0 = tid == 0
    bidx = torch.arange(B, device=device)
    single = B == 1
    tdx_t = torch.tensor(tdx, dtype=torch.int32, device=device)[:, None]
    cache = {"pred": None}

    def step(ds: DeviceState, tr: torch.Tensor, ops: tuple, host_row=None):
        if not ops:
            return
        if single:
            # views: one instruction writes one register column or shared
            # memory, and reads its operands before that write
            _, typ, rd, ra, rb, imm, tsc = host_row
            rdv, rav, rbv = (ds.regs[:, :, r] for r in (rd, ra, rb))
            tsc_mask = masks[:, tsc]
            signed, imm_v, tdx_v = typ == Typ.I32, imm, tdx[0]
        else:
            vals = torch.gather(ds.regs, 2, tr[:, None, 2:5].expand(B, T, 3))
            rdv, rav, rbv = vals[..., 0], vals[..., 1], vals[..., 2]
            tsc_mask = masks[bidx, tr[:, 6]]
            signed = (tr[:, 1:2] == Typ.I32)
            imm_v = tr[:, 5:6].to(torch.int32)
            tdx_v = tdx_t
        mask = tsc_mask if cache["pred"] is None else tsc_mask & cache["pred"]
        env = semantics.OpEnv(cfg=cfg, rav=rav, rbv=rbv, rdv=rdv,
                              signed=signed, imm=imm_v, mask=mask, tid=tid,
                              shared=ds.shared, tdx_dim=tdx_v)

        def on(o):
            return None if single else (tr[:, 0] == o)[:, None]

        # --- register write-back: one column, mask-gated -----------------
        col, wrote = rdv, False
        for o in ops:
            if not writes_rd[o]:
                continue
            wm = _gate(is_t0.expand_as(mask) if o in _EXT0 else mask, on(o))
            val = semantics.build_spec(
                dataclasses.replace(env, wmask=wm))[o][0]()
            col = torch.where(wm, val, col)
            wrote = True
        if wrote:
            if single:
                ds.regs[:, :, rd] = col
            else:
                ds.regs.scatter_(2, tr[:, None, 2:3].expand(B, T, 1),
                                 col[..., None])

        # --- shared-memory write (STO): one flattened scatter ------------
        if int(Op.STO) in ops:
            addr = env.addr
            ok = _gate(mask & (addr >= 0) & (addr < S), on(int(Op.STO)))
            sidx = torch.where(ok, addr, S)
            semantics.store(ds.shared, sidx, rdv)

        # --- predicate stacks ---------------------------------------------
        pred_ops = [o for o in ops if o in _IF_RANGE
                    or o in (int(Op.ELSE), int(Op.ENDIF))]
        if pred_ops:
            pstack, pdepth = ds.pstack, ds.pdepth
            ifs = [o for o in pred_ops if o in _IF_RANGE]
            if ifs:
                spec = semantics.build_spec(env)
                cond, is_if = None, None
                for o in ifs:
                    c = spec[o][1]()
                    cond = c if cond is None else torch.where(on(o), c, cond)
                    is_if = on(o) if is_if is None else is_if | on(o)
                ps, pd = semantics.pred_push(pstack, pdepth, cond, tsc_mask, D)
                pstack = _pick(is_if, ps, pstack)
                pdepth = _pick(is_if, pd, pdepth)
            if int(Op.ELSE) in pred_ops:
                ps = semantics.pred_else(ds.pstack, ds.pdepth, tsc_mask, D)
                pstack = _pick(on(int(Op.ELSE)), ps, pstack)
            if int(Op.ENDIF) in pred_ops:
                pd = semantics.pred_pop(ds.pdepth, tsc_mask)
                pdepth = _pick(on(int(Op.ENDIF)), pd, pdepth)
            ds.pstack, ds.pdepth = pstack, pdepth
            cache["pred"] = semantics.pred_ok(pstack, pdepth, D)

    def reset_pred(ds: DeviceState, nontrivial: bool):
        cache["pred"] = (semantics.pred_ok(ds.pstack, ds.pdepth, D)
                         if nontrivial else None)

    step.reset_pred = reset_pred
    return step


def run_steps(step, ds: DeviceState, trace_dev: torch.Tensor,
              step_ops: list, host_rows: list) -> None:
    """The device loop: one data-path step per trace row.  Everything it
    reads is on the device or in host lists already, so on CUDA it never
    waits for the card."""
    for i in range(len(step_ops)):
        step(ds, trace_dev[i], step_ops[i], host_rows[i])


def run_batch(cfg: EGPUConfig, packed: list, leaves: list, prog_len: int,
              validate: bool, device: torch.device) -> MachineState:
    """The driver shared by :func:`run_program` (one core) and the fleet:
    sequence every core on the host, upload the padded ``(steps, B, 7)``
    trace once, then run the device data path step by step.  ``leaves``
    are the cores' initial states as numpy dicts.  Returns the batched
    final state ``(B, ...)`` on ``device``."""
    B = len(packed)
    cores = [HostCore.from_leaves(lv) for lv in leaves]
    pcs = [sequence(p, prog_len, cfg, c, validate)
           for p, c in zip(packed, cores)]
    n = max((len(p) for p in pcs), default=0)
    trace = np.zeros((n, B, 7), np.int64)
    trace[:, :, _PF_OP] = _NOP
    for b, (p, pc) in enumerate(zip(packed, pcs)):
        trace[:len(pc), b] = p[pc]
    op_rows = trace[:, :, _PF_OP].tolist()
    step_ops = [tuple(sorted(set(r) - {_NOP})) for r in op_rows]

    stack = lambda k: np.stack([lv[k] for lv in leaves])
    S = cfg.shared_words
    shared = np.zeros((B, S + 1), np.uint32)
    shared[:, :S] = stack("shared")
    ds = DeviceState(
        regs=torch.from_numpy(stack("regs").view(np.int32)).to(device),
        shared=torch.from_numpy(shared.view(np.int32)).to(device),
        pstack=torch.from_numpy(stack("pstack")).to(device),
        pdepth=torch.from_numpy(stack("pdepth")).to(device))
    masks = torch.from_numpy(np.stack(
        [tsc_masks(cfg, c.threads_active) for c in cores])).to(device)
    step = make_step(cfg, masks, [c.tdx_dim for c in cores], device)
    step.reset_pred(ds, bool(stack("pdepth").any()))
    trace_dev = torch.from_numpy(trace).to(device)
    host_rows = trace[:, 0].tolist() if B == 1 else [None] * n
    run_steps(step, ds, trace_dev, step_ops, host_rows)

    host = [c.leaves() for c in cores]
    out = {k: torch.from_numpy(np.stack([h[k] for h in host])).to(device)
           for k in host[0]}
    return MachineState(regs=ds.regs, shared=ds.shared[:, :S].contiguous(),
                        pstack=ds.pstack, pdepth=ds.pdepth, **out)


def run_program(image: ProgramImage, state: MachineState | None = None, *,
                validate: bool = True, device="cuda",
                **init_kw) -> MachineState:
    """Execute an assembled program to completion (interpreter tier).

    ``state`` (optional) is the starting state; otherwise ``init_kw``
    (``shared_init``, ``tdx_dim``, ``threads``) build one.  Runs on the
    card unless ``device="cpu"``; ``state``, if given, decides the
    device.  ``validate=False`` leaves the hazard rows and the Fig. 6
    counters untouched, as the reference's.  The result's leaves equal
    the reference's ``run_program`` bit for bit.
    """
    cfg = image.cfg
    if state is None:
        dev = resolve_device(device)
        init_kw.setdefault("threads", image.threads_active)
        leaves = init_numpy(cfg, **init_kw)
    else:
        dev = state.regs.device
        leaves = state_to_numpy(state)
    packed, length = pad_image(image)
    with obs_trace.span("interpret", prog_len=length, device=str(dev)):
        out = run_batch(cfg, [packed], [leaves], length, validate, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return MachineState(*(leaf[0] for leaf in out))
