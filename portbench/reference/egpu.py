"""A plain NumPy eGPU core: the benchmark's reference for the simulator.

It reads the instruction words of a program and the jobs' initial shared
memory, and gives back what a job's ``JobResult`` must hold: the final
shared memory of every job, and the cycles, steps and Fig. 6 counters of
the program's path.  It is written from the ISA's definition (paper
Table 2, Fig. 3, Table 3) and shares no code with the program under
test: the instruction set, the cost model and the x86 float32 rules that
the simulator's contract fixes are spelt out here again.

The eGPU has no data-dependent branch, so the control (PC, call and loop
stacks, cycles, counters) runs once per program in Python ints
(:func:`sequence`) and the data path runs over a batch of jobs of that
program in NumPy, one executed instruction at a time (:func:`run`).

``precision="bf16"`` is the benchmark's control: every float32 operand
and result of FADD/FSUB/FMUL and of DOT/SUM is rounded to bfloat16, the
step below the float32 that the configuration states.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# ---------------------------------------------------------------------------
# The instruction set (Table 2): opcode numbers of the 6-bit field
# ---------------------------------------------------------------------------

OPS = ("ADD SUB NEG ABS MUL16LO MUL16HI MUL24LO MUL24HI AND OR XOR NOT "
       "CNOT BVS SHL SHR POP MAX MIN FADD FSUB FNEG FABS FMUL FMAX FMIN "
       "LOD STO LODI TDX TDY DOT SUM INVSQR JMP JSR RTS LOOP INIT STOP NOP "
       "IF_EQ IF_NE IF_LT IF_LO IF_LE IF_LS IF_GT IF_HI IF_GE IF_HS IF_FEQ "
       "IF_FNE IF_FLT IF_FLE IF_FGT IF_FGE IF_Z IF_NZ ELSE ENDIF").split()
OP = {name: i for i, name in enumerate(OPS)}
I32 = 1                                  # the typ field's signed coding

SCALAR = {OP[n] for n in ("JMP", "JSR", "RTS", "LOOP", "INIT", "STOP",
                          "NOP")}
IFS = set(range(OP["IF_EQ"], OP["IF_NZ"] + 1))
FP_BINARY = {OP["FADD"], OP["FSUB"], OP["FMUL"], OP["FMAX"], OP["FMIN"]}

# instruction classes of the Fig. 6 profile
NOPC, INT, FP, MEM_RD, MEM_WR, BRANCH, THREAD, EXT, COND = range(9)
N_CLASSES = 9


def op_class(op: int) -> int:
    name = OPS[op]
    if name == "NOP":
        return NOPC
    if name in ("FADD", "FSUB", "FNEG", "FABS", "FMUL", "FMAX", "FMIN"):
        return FP
    if name == "LOD":
        return MEM_RD
    if name == "STO":
        return MEM_WR
    if op in SCALAR:
        return BRANCH
    if name in ("TDX", "TDY", "LODI"):
        return THREAD
    if name in ("DOT", "SUM", "INVSQR"):
        return EXT
    if op >= OP["IF_EQ"]:
        return COND
    return INT


#: lanes enabled by the TSC width coding (Table 3); 3 is undefined
WIDTH_LANES = (16, 4, 1, 16)
PAD = 64                                 # programs run padded with STOPs


@dataclasses.dataclass(frozen=True)
class Core:
    """The configuration knobs the reference reads (``configs/*.json``)."""

    max_threads: int
    regs_per_thread: int
    shared_kb: int
    memory_mode: str
    alu_bits: int
    shift_bits: int
    predicate_levels: int
    max_loop_depth: int
    max_call_depth: int
    max_steps: int
    sp_read_ports: int
    num_sps: int = 16

    @classmethod
    def from_config(cls, doc: dict) -> "Core":
        c, cost = doc["config"], doc["cost"]
        return cls(max_threads=c["max_threads"],
                   regs_per_thread=c["regs_per_thread"],
                   shared_kb=c["shared_kb"], memory_mode=c["memory_mode"],
                   alu_bits=c["alu_bits"], shift_bits=c["shift_bits"],
                   predicate_levels=c["predicate_levels"],
                   max_loop_depth=c["max_loop_depth"],
                   max_call_depth=c["max_call_depth"],
                   max_steps=c["max_steps"],
                   sp_read_ports=cost["sp_read_ports"],
                   num_sps=c["num_sps"])

    @property
    def shared_words(self) -> int:
        return self.shared_kb * 1024 // 4

    @property
    def write_ports(self) -> int:
        return 2 if self.memory_mode == "qp" else 1


# ---------------------------------------------------------------------------
# Instruction words (Fig. 3): [tsc:4][op:6][typ:2][rd][ra][rb][imm:16][0]
# ---------------------------------------------------------------------------

def decode(words, regs_per_thread: int) -> np.ndarray:
    """``(n, 7)`` int64 rows ``op, typ, rd, ra, rb, imm, tsc`` of the
    words (``imm`` sign-extended)."""
    rb_ = max(1, (regs_per_thread - 1).bit_length())
    rows = []
    for w in words:
        w = int(w)
        imm = (w >> 1) & 0xFFFF
        imm -= (imm & 0x8000) << 1
        pos = 17
        fields = []
        for _ in range(3):                       # rb, ra, rd
            fields.append((w >> pos) & ((1 << rb_) - 1))
            pos += rb_
        rbv, rav, rdv = fields
        typ = (w >> pos) & 0x3
        op = (w >> (pos + 2)) & 0x3F
        tsc = (w >> (pos + 8)) & 0xF
        rows.append((op, typ, rdv, rav, rbv, imm, tsc))
    return np.asarray(rows, np.int64).reshape(-1, 7)


# ---------------------------------------------------------------------------
# Control: the path, cycles and counters of one program
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Path:
    """What a program's run is, whatever its data: the rows executed in
    order, and the leaves a ``JobResult`` reports for it."""

    rows: np.ndarray         # (steps, 7) the executed rows
    cycles: int
    steps: int
    stat_cycles: np.ndarray  # (9,) int64
    stat_instrs: np.ndarray  # (9,) int64


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _wavefronts(core: Core, threads: int) -> tuple:
    w = _cdiv(threads, core.num_sps)
    return (1, w, max(1, _cdiv(w, 2)), max(1, _cdiv(w, 4)))


def issue_cycles(core: Core, op: int, tsc: int, threads: int) -> int:
    """Cycles an instruction holds the issue stage: one for a sequencer
    op, else one a wavefront, shared-memory ops limited by their ports."""
    if op in SCALAR:
        return 1
    lanes = WIDTH_LANES[(tsc >> 2) & 3]
    wfs = _wavefronts(core, threads)[tsc & 3]
    if op == OP["LOD"]:
        return wfs * _cdiv(lanes, core.sp_read_ports)
    if op == OP["STO"]:
        return wfs * _cdiv(lanes, core.write_ports)
    return wfs


def _stack_index(i: int, n: int) -> int:
    """A stack read below the bottom wraps once, then clamps."""
    if i < 0:
        i += n
    return min(max(i, 0), n - 1)


def sequence(core: Core, rows: np.ndarray, threads: int) -> Path:
    """Run a program's control from PC 0 with empty stacks to STOP (or
    ``max_steps``, or a PC past the padded program)."""
    n = rows.shape[0]
    length = n + (-n) % PAD
    prog = rows.tolist() + [[OP["STOP"], 0, 0, 0, 0, 0, 0]] * (length - n)
    lctr = [0] * core.max_loop_depth
    cstack = [0] * core.max_call_depth
    lsp = csp = pc = cycles = steps = 0
    sc = [0] * N_CLASSES
    si = [0] * N_CLASSES
    pcs = []
    while steps < core.max_steps and 0 <= pc < length:
        op, _, _, _, _, imm, tsc = prog[pc]
        pcs.append(pc)
        issue = issue_cycles(core, op, tsc, threads)
        cls = op_class(op)
        sc[cls] += issue
        si[cls] += 1
        cycles += issue
        steps += 1
        nxt = pc + 1
        name = OPS[op]
        if name == "JMP":
            nxt = imm
        elif name == "JSR":
            if 0 <= csp < len(cstack):
                cstack[csp] = pc + 1
            csp += 1
            nxt = imm
        elif name == "RTS":
            nxt = cstack[_stack_index(csp - 1, len(cstack))]
            csp -= 1
        elif name == "LOOP":
            top = lctr[_stack_index(lsp - 1, len(lctr))]
            if 0 <= lsp - 1 < len(lctr):
                lctr[lsp - 1] = top - 1
            if top > 0:
                nxt = imm
            else:
                lsp -= 1
        elif name == "INIT":
            if 0 <= lsp < len(lctr):
                lctr[lsp] = imm
            lsp += 1
        pc = nxt
        if name == "STOP":
            break
    full = np.asarray(prog, np.int64)
    return Path(rows=full[np.asarray(pcs, np.int64)], cycles=cycles,
                steps=steps, stat_cycles=np.asarray(sc, np.int64),
                stat_instrs=np.asarray(si, np.int64))


# ---------------------------------------------------------------------------
# float32 as the reference's x86 float unit computes it, on bit patterns:
# denormals read as zero, tiny results flush to zero, x86 NaN selection
# ---------------------------------------------------------------------------

U32 = np.uint32
SIGN, ABS, EXP, QUIET = U32(0x80000000), U32(0x7FFFFFFF), U32(0x7F800000), \
    U32(0x00400000)
DEFAULT_NAN = U32(0xFFC00000)
TINY = 2.0 ** -126 - 2.0 ** -151


def _f(x):
    return x.view(np.float32)


def _is_nan(x):
    return (x & ABS) > EXP


def _daz(x):
    return np.where((x & EXP) == 0, x & SIGN, x)


def _nan_rules(a, b, r):
    r = np.where(_is_nan(r), DEFAULT_NAN, r)
    r = np.where(_is_nan(b), b | QUIET, r)
    return np.where(_is_nan(a), a | QUIET, r)


def _bf16(x):
    """Round float32 bit patterns to bfloat16 (nearest, ties to even);
    NaNs stay NaNs."""
    r = (x + U32(0x7FFF) + ((x >> U32(16)) & U32(1))) & U32(0xFFFF0000)
    return np.where(_is_nan(x), x | QUIET, r)


class Float:
    """The float unit at one precision: ``"f32"``, or ``"bf16"`` (the
    control: operands and results of add, sub and mul rounded)."""

    def __init__(self, precision: str = "f32"):
        if precision not in ("f32", "bf16"):
            raise ValueError(f"unknown precision {precision!r}")
        self.low = precision == "bf16"

    def _in(self, x):
        return _bf16(x) if self.low else x

    def add(self, a, b, sub=False):
        a, b = self._in(a), self._in(b)
        x, y = _f(_daz(a)), _f(_daz(b))
        r = (x - y if sub else x + y).view(U32)
        r = self._in(_daz(r))
        return _nan_rules(a, b, r)

    def mul(self, a, b):
        a, b = self._in(a), self._in(b)
        da, db = _daz(a), _daz(b)
        p = _f(da).astype(np.float64) * _f(db).astype(np.float64)
        r = p.astype(np.float32).view(U32)
        r = np.where(np.abs(p) < TINY, (da ^ db) & SIGN, r)
        r = self._in(r)
        return _nan_rules(a, b, r)

    @staticmethod
    def maximum(a, b):
        neg = a.view(np.int32) < 0
        x, y = np.where(neg, a, b), np.where(neg, b, a)
        r = np.where(_f(_daz(y)) < _f(_daz(x)), _daz(x), _daz(y))
        return np.where(_is_nan(x), x, r)

    @staticmethod
    def minimum(a, b):
        neg = a.view(np.int32) < 0
        x, y = np.where(neg, b, a), np.where(neg, a, b)
        r = np.where(_f(_daz(x)) < _f(_daz(y)), _daz(x), _daz(y))
        return np.where(_is_nan(x), x, r)

    def dot(self, a, b, num_sps: int):
        """``sum(a * b)`` over the last axis ``T``, in the order the
        extension unit fixes: each lane accumulates its wavefronts in
        order, then a halving tree across the 16 lanes."""
        p = self.mul(a, b)
        m = p.reshape(p.shape[:-1] + (-1, num_sps))
        if not self.low:
            # IEEE float32 adds in the same order give the same bits
            # where no operand or partial sum is a NaN, an infinity or a
            # subnormal (the x86 rules differ only there)
            part = [np.add.accumulate(_f(m), axis=-2)]
            acc = part[0][..., -1, :]
            s = num_sps // 2
            while s >= 1:
                acc = acc[..., :s] + acc[..., s:2 * s]
                part.append(acc)
                s //= 2
            bits = [x.view(U32) for x in part] + [m]
            if not any(((x & EXP) == EXP).any()
                       | (((x & EXP) == 0) & ((x & ABS) != 0)).any()
                       for x in bits):
                return acc[..., 0].view(U32)
        acc = m[..., 0, :]
        for i in range(1, m.shape[-2]):
            acc = self.add(acc, m[..., i, :])
        s = num_sps // 2
        while s >= 1:
            acc = self.add(acc[..., :s], acc[..., s:2 * s])
            s //= 2
        return acc[..., 0]


def compare(a, b, how: str):
    x, y = _f(_daz(a)), _f(_daz(b))
    return {"FEQ": x == y, "FNE": x != y, "FLT": x < y, "FLE": x <= y,
            "FGT": x > y, "FGE": x >= y}[how]


# ---------------------------------------------------------------------------
# Integer helpers on 32-bit patterns
# ---------------------------------------------------------------------------

def _s(x):
    return x.view(np.int32)


def _sext(x, bits: int):
    v = (x & U32((1 << bits) - 1)).astype(np.int64)
    return np.where(v >= 1 << (bits - 1), v - (1 << bits), v)


def _bitrev(x):
    x = ((x & U32(0x55555555)) << U32(1)) | ((x >> U32(1)) & U32(0x55555555))
    x = ((x & U32(0x33333333)) << U32(2)) | ((x >> U32(2)) & U32(0x33333333))
    x = ((x & U32(0x0F0F0F0F)) << U32(4)) | ((x >> U32(4)) & U32(0x0F0F0F0F))
    x = ((x & U32(0x00FF00FF)) << U32(8)) | ((x >> U32(8)) & U32(0x00FF00FF))
    return (x << U32(16)) | (x >> U32(16))


def _popcount(x):
    return np.unpackbits(x.view(np.uint8).reshape(x.shape + (4,)),
                         axis=-1).sum(-1).astype(U32)


def _trunc(v):
    """The low 32 bits of an integer array, as a bit pattern."""
    return (np.asarray(v, np.int64) & 0xFFFFFFFF).astype(U32)


# ---------------------------------------------------------------------------
# The data path
# ---------------------------------------------------------------------------

def tsc_masks(core: Core, threads: int) -> np.ndarray:
    """``(16, T)``: the threads each TSC coding enables."""
    tid = np.arange(core.max_threads)
    lane, wf = tid % core.num_sps, tid // core.num_sps
    wfs = _wavefronts(core, threads)
    out = np.zeros((16, core.max_threads), bool)
    for tsc in range(16):
        out[tsc] = ((lane < WIDTH_LANES[(tsc >> 2) & 3])
                    & (wf < wfs[tsc & 3]) & (tid < threads))
    return out


def run(core: Core, path: Path, threads: int, tdx_dim: int,
        shared_init: np.ndarray, precision: str = "f32") -> np.ndarray:
    """Run one program's path over a batch of jobs: ``shared_init``
    ``(B, S)`` uint32 (each job's whole initial shared memory) -> the
    final shared memory ``(B, S)`` uint32."""
    fpu = Float(precision)
    B = shared_init.shape[0]
    T, R, S = core.max_threads, core.regs_per_thread, core.shared_words
    D = max(1, core.predicate_levels)
    shared = np.array(shared_init, U32, copy=True)
    regs = np.zeros((B, T, R), U32)
    pstack = np.zeros((B, T, D), bool)
    pdepth = np.zeros((B, T), np.int64)
    pred = None                                  # all levels True
    masks = tsc_masks(core, threads)
    tid = np.arange(T, dtype=np.int64)
    lvl = np.arange(D)
    ialu = (lambda v: v & U32(0xFFFF)) if core.alu_bits == 16 \
        else (lambda v: v)
    sh_mask = U32(core.alu_bits - 1 if core.shift_bits > 1 else 1)
    with np.errstate(all="ignore"):
        for op, typ, rd, ra, rb, imm, tsc in path.rows.tolist():
            if op in SCALAR:
                continue
            name = OPS[op]
            tmask = np.broadcast_to(masks[tsc], (B, T))
            wm = tmask if pred is None else tmask & pred
            a, b = regs[:, :, ra], regs[:, :, rb]
            signed = typ == I32
            val = None
            if name == "ADD":
                val = ialu(a + b)
            elif name == "SUB":
                val = ialu(a - b)
            elif name == "NEG":
                val = ialu(U32(0) - a)
            elif name == "ABS":
                val = ialu(np.abs(_s(a)).view(U32))
            elif name in ("MUL16LO", "MUL16HI"):
                if signed:
                    p = _sext(a, 16) * _sext(b, 16)
                else:
                    p = (a & U32(0xFFFF)).astype(np.int64) \
                        * (b & U32(0xFFFF)).astype(np.int64)
                val = ialu(_trunc(p if name == "MUL16LO" else p >> 16))
            elif name in ("MUL24LO", "MUL24HI"):
                if signed:
                    p = _sext(a, 24) * _sext(b, 24)
                else:
                    p = (a & U32(0xFFFFFF)).astype(np.int64) \
                        * (b & U32(0xFFFFFF)).astype(np.int64)
                val = ialu(_trunc(p if name == "MUL24LO" else p >> 24))
            elif name == "AND":
                val = ialu(a & b)
            elif name == "OR":
                val = ialu(a | b)
            elif name == "XOR":
                val = ialu(a ^ b)
            elif name == "NOT":
                val = ialu(~a)
            elif name == "CNOT":
                val = ialu((a == 0).astype(U32))
            elif name == "BVS":
                val = ialu(_bitrev(a))
            elif name == "SHL":
                val = ialu(a << (b & sh_mask))
            elif name == "SHR":
                amt = b & sh_mask
                val = ialu((_s(a) >> _s(amt)).view(U32) if signed
                           else a >> amt)
            elif name == "POP":
                val = ialu(_popcount(a))
            elif name in ("MAX", "MIN"):
                x, y = (_s(a), _s(b)) if signed else (a, b)
                val = ialu((np.maximum if name == "MAX" else np.minimum)(
                    x, y).view(U32))
            elif name in ("FADD", "FSUB"):
                val = fpu.add(a, b, sub=name == "FSUB")
            elif name == "FMUL":
                val = fpu.mul(a, b)
            elif name == "FMAX":
                val = fpu.maximum(a, b)
            elif name == "FMIN":
                val = fpu.minimum(a, b)
            elif name == "FNEG":
                val = a ^ SIGN
            elif name == "FABS":
                val = a & ABS
            elif name == "LOD":
                addr = (_s(a).astype(np.int64) + imm + 2 ** 31) \
                    % 2 ** 32 - 2 ** 31
                val = np.take_along_axis(shared, np.clip(addr, 0, S - 1), 1)
            elif name == "LODI":
                val = ialu(np.full((B, T), imm & 0xFFFFFFFF, U32))
            elif name in ("TDX", "TDY"):
                v = tid % tdx_dim if name == "TDX" else tid // tdx_dim
                val = ialu(np.broadcast_to(v.astype(U32), (B, T)))
            elif name in ("DOT", "SUM"):
                x = np.where(wm, a, U32(0))
                y = np.where(wm, b, U32(0)) if name == "DOT" \
                    else np.full((B, T), 0x3F800000, U32)
                regs[:, 0, rd] = fpu.dot(x, y, core.num_sps)
                continue
            elif name == "STO":
                addr = (_s(a).astype(np.int64) + imm + 2 ** 31) \
                    % 2 ** 32 - 2 ** 31
                ok = wm & (addr >= 0) & (addr < S)
                jb, jt = np.nonzero(ok)           # row-major: tid ascends
                flat = jb * S + addr[jb, jt]
                # where threads of a job store to one word, the highest
                # tid wins: keep each word's last occurrence
                _, last = np.unique(flat[::-1], return_index=True)
                keep = flat.size - 1 - last
                shared.reshape(-1)[flat[keep]] = regs[jb[keep], jt[keep], rd]
                continue
            elif op in IFS:
                how = name[3:]
                if how in ("Z", "NZ"):
                    cond = (a == 0) if how == "Z" else (a != 0)
                elif how.startswith("F"):
                    cond = compare(a, b, how)
                else:
                    x, y = (_s(a), _s(b)) if how in (
                        "EQ", "NE", "LT", "LE", "GT", "GE") else (a, b)
                    cond = {"EQ": x == y, "NE": x != y, "LT": x < y,
                            "LO": x < y, "LE": x <= y, "LS": x <= y,
                            "GT": x > y, "HI": x > y, "GE": x >= y,
                            "HS": x >= y}[how]
                oh = (lvl == pdepth[..., None]) & tmask[..., None]
                pstack = np.where(oh, cond[..., None], pstack)
                pdepth = pdepth + (tmask & (pdepth < D))
            elif name == "ELSE":
                oh = (lvl == pdepth[..., None] - 1) & tmask[..., None] \
                    & (pdepth[..., None] > 0)
                pstack = pstack ^ oh
            elif name == "ENDIF":
                pdepth = pdepth - (tmask & (pdepth > 0))
            else:
                raise NotImplementedError(
                    f"the reference has no {name} (add it with its cell)")
            if val is not None:
                col = regs[:, :, rd]
                regs[:, :, rd] = np.where(wm, val, col)
            else:
                pred = np.all(pstack | (lvl >= pdepth[..., None]), -1)
    return shared


def shared_init_rows(core: Core, inputs: np.ndarray, fixed: np.ndarray
                     ) -> np.ndarray:
    """Each job's whole initial shared memory: its input words, then the
    program's fixed words, then zeros."""
    B, k = inputs.shape
    out = np.zeros((B, core.shared_words), U32)
    out[:, :k] = inputs.view(U32)
    out[:, k:k + fixed.size] = fixed
    return out
