"""eGPU instruction set architecture.

Faithful to Table 2 / Figure 3 of "A Statically and Dynamically Scalable
Soft GPGPU" (Langhammer & Constantinides, 2024).

The ISA has exactly 61 instructions, including 18 conditional (IF.cc)
cases.  The instruction word (IW) is parameterised by the number of
registers per thread (Fig. 3 shows the 43-bit / 32-register form):

    [tsc:4][opcode:6][type:2][rd:RB][ra:RB][rb:RB][imm:16]

where RB = ceil(log2(regs_per_thread)).  The 4-bit thread-space control
(TSC) field encodes the dynamic wavefront width/depth per Table 3.
"""
from __future__ import annotations

import enum
from typing import NamedTuple


class Op(enum.IntEnum):
    """The 61 eGPU opcodes (dense encoding, 6-bit field)."""

    # -- Integer arithmetic (4) ------------------------------------------
    ADD = 0
    SUB = 1
    NEG = 2
    ABS = 3
    # -- Integer multiply (4) --------------------------------------------
    MUL16LO = 4
    MUL16HI = 5
    MUL24LO = 6
    MUL24HI = 7
    # -- Integer logic (6) -----------------------------------------------
    AND = 8
    OR = 9
    XOR = 10
    NOT = 11
    CNOT = 12   # Rd = (Ra == 0) ? 1 : 0
    BVS = 13    # Rd = bit_reverse(Ra)
    # -- Integer shift (2) -----------------------------------------------
    SHL = 14
    SHR = 15
    # -- Integer other (3) -----------------------------------------------
    POP = 16    # population count
    MAX = 17
    MIN = 18
    # -- FP ALU (7) --------------------------------------------------------
    FADD = 19
    FSUB = 20
    FNEG = 21
    FABS = 22
    FMUL = 23
    FMAX = 24
    FMIN = 25
    # -- Memory (2) --------------------------------------------------------
    LOD = 26    # Rd = shared[Ra + offset]
    STO = 27    # shared[Ra + offset] = Rd
    # -- Immediate (1) -----------------------------------------------------
    LODI = 28   # Rd = imm (sign-extended 16-bit)
    # -- Thread id (2) -----------------------------------------------------
    TDX = 29
    TDY = 30
    # -- Extension units (3) -------------------------------------------------
    DOT = 31     # Rd[thread0] = <Ra, Rb> over active thread space
    SUM = 32     # Rd[thread0] = sum(Ra) over active thread space
    INVSQR = 33  # Rd = 1/sqrt(Ra)
    # -- Control (7) ---------------------------------------------------------
    JMP = 34
    JSR = 35
    RTS = 36
    LOOP = 37   # dec loop ctr; jump if != 0 else pop
    INIT = 38   # push loop ctr = imm
    STOP = 39
    NOP = 40
    # -- Conditionals: 18 IF.cc cases + ELSE + ENDIF (20) ---------------------
    IF_EQ = 41
    IF_NE = 42
    IF_LT = 43   # signed <
    IF_LO = 44   # unsigned <
    IF_LE = 45   # signed <=
    IF_LS = 46   # unsigned <=
    IF_GT = 47   # signed >
    IF_HI = 48   # unsigned >
    IF_GE = 49   # signed >=
    IF_HS = 50   # unsigned >=
    IF_FEQ = 51
    IF_FNE = 52
    IF_FLT = 53
    IF_FLE = 54
    IF_FGT = 55
    IF_FGE = 56
    IF_Z = 57    # Ra == 0
    IF_NZ = 58   # Ra != 0
    ELSE = 59
    ENDIF = 60


NUM_OPCODES = len(Op)
assert NUM_OPCODES == 61, NUM_OPCODES

_IF_OPS = tuple(op for op in Op if op.name.startswith("IF_"))
assert len(_IF_OPS) == 18  # "including 18 conditional cases"

#: The 18 IF.cc comparison opcodes (they push one predicate level).
IF_OPS = frozenset(_IF_OPS)

#: Ops that modify the per-thread predicate state: every IF.cc pushes a
#: level, ELSE flips the top, ENDIF pops.  Hazard tracking (executor,
#: assembler) keys the virtual predicate slot off this set — NOT off the
#: opcode ordering — so growing the enum past ENDIF cannot silently tag
#: new sequencer ops as predicate writers.
PRED_WRITE_OPS = frozenset(_IF_OPS) | {Op.ELSE, Op.ENDIF}


class Typ(enum.IntEnum):
    """2-bit representation field (Fig. 3)."""

    U32 = 0
    I32 = 1
    F32 = 2


# ---------------------------------------------------------------------------
# Thread-space control (Table 3).
#
#   width  [4:3]: 00 = all 16 SPs, 01 = first 4 SPs, 10 = SP0 only,
#                 11 = undefined (we reject it at assembly time)
#   depth  [2:1]: 00 = wavefront 0 only, 01 = all wavefronts,
#                 10 = first 1/2 wavefronts, 11 = first 1/4 wavefronts
# ---------------------------------------------------------------------------

WIDTH_ALL, WIDTH_QUARTER, WIDTH_ONE = 0, 1, 2
DEPTH_WF0, DEPTH_ALL, DEPTH_HALF, DEPTH_QUARTER = 0, 1, 2, 3

#: lanes enabled for each width code (index 3 is the undefined coding;
#: hardware behaviour is unspecified — we treat it as full width but the
#: assembler refuses to emit it).
WIDTH_LANES = (16, 4, 1, 16)


def tsc_encode(width: int, depth: int) -> int:
    if width == 3:
        raise ValueError("TSC width coding '11' is undefined (Table 3)")
    return ((width & 0x3) << 2) | (depth & 0x3)


def tsc_width(tsc: int) -> int:
    return (tsc >> 2) & 0x3


def tsc_depth(tsc: int) -> int:
    return tsc & 0x3


# Common "personalities" (paper §3.1): full SIMT, multithreaded CPU, MCU.
TSC_FULL = tsc_encode(WIDTH_ALL, DEPTH_ALL)          # standard SIMT
TSC_WF0 = tsc_encode(WIDTH_ALL, DEPTH_WF0)           # one wavefront
TSC_CPU = tsc_encode(WIDTH_ONE, DEPTH_ALL)           # multithreaded CPU (SP0)
TSC_MCU = tsc_encode(WIDTH_ONE, DEPTH_WF0)           # single thread 0
TSC_QUARTER = tsc_encode(WIDTH_QUARTER, DEPTH_ALL)   # first 4 SPs
TSC_HALF_DEPTH = tsc_encode(WIDTH_ALL, DEPTH_HALF)
TSC_QUARTER_DEPTH = tsc_encode(WIDTH_ALL, DEPTH_QUARTER)

PERSONALITIES = {
    "full": TSC_FULL,
    "wf0": TSC_WF0,
    "cpu": TSC_CPU,
    "mcu": TSC_MCU,
    "quarter": TSC_QUARTER,
    "half_depth": TSC_HALF_DEPTH,
    "quarter_depth": TSC_QUARTER_DEPTH,
}


# ---------------------------------------------------------------------------
# Instruction classes — used for cost accounting and the Fig. 6 profile.
# ---------------------------------------------------------------------------

class OpClass(enum.IntEnum):
    NOPC = 0       # NOPs (incl. hazard padding)
    INT = 1        # integer ALU (arith/mul/logic/shift/other)
    FP = 2         # FP ALU
    MEM_RD = 3     # shared-memory reads
    MEM_WR = 4     # shared-memory writes
    BRANCH = 5     # control flow (JMP/JSR/RTS/LOOP/INIT/STOP)
    THREAD = 6     # thread-id / immediate loads
    EXT = 7        # extension units (DOT/SUM/INVSQR)
    COND = 8       # predicates (IF/ELSE/ENDIF)


NUM_OP_CLASSES = len(OpClass)


def _opclass(op: Op) -> OpClass:
    if op == Op.NOP:
        return OpClass.NOPC
    if op in (Op.FADD, Op.FSUB, Op.FNEG, Op.FABS, Op.FMUL, Op.FMAX, Op.FMIN):
        return OpClass.FP
    if op == Op.LOD:
        return OpClass.MEM_RD
    if op == Op.STO:
        return OpClass.MEM_WR
    if op in (Op.JMP, Op.JSR, Op.RTS, Op.LOOP, Op.INIT, Op.STOP):
        return OpClass.BRANCH
    if op in (Op.TDX, Op.TDY, Op.LODI):
        return OpClass.THREAD
    if op in (Op.DOT, Op.SUM, Op.INVSQR):
        return OpClass.EXT
    if op.value >= Op.IF_EQ:
        return OpClass.COND
    return OpClass.INT


OP_CLASS = tuple(_opclass(op) for op in Op)

#: Vector ops run over the thread space (charged per active wavefront);
#: scalar ops are sequencer-only and cost one cycle.
SCALAR_OPS = frozenset(
    {Op.JMP, Op.JSR, Op.RTS, Op.LOOP, Op.INIT, Op.STOP, Op.NOP}
)

#: Ops that write a destination register (per-thread, mask-gated).
REG_WRITE_OPS = frozenset(
    op for op in Op
    if op not in SCALAR_OPS
    and op not in (Op.STO, Op.ELSE, Op.ENDIF)
    and not op.name.startswith("IF_")
)

#: Ops reading Ra / Rb (for hazard scheduling).
READS_RA = frozenset(
    op for op in Op
    if op not in SCALAR_OPS and op not in (Op.LODI, Op.TDX, Op.TDY, Op.ELSE, Op.ENDIF)
)
_TWO_SRC = {
    Op.ADD, Op.SUB, Op.MUL16LO, Op.MUL16HI, Op.MUL24LO, Op.MUL24HI,
    Op.AND, Op.OR, Op.XOR, Op.SHL, Op.SHR, Op.MAX, Op.MIN,
    Op.FADD, Op.FSUB, Op.FMUL, Op.FMAX, Op.FMIN, Op.DOT, Op.SUM,
}
READS_RB = frozenset(_TWO_SRC | {op for op in _IF_OPS if op not in (Op.IF_Z, Op.IF_NZ)})
#: STO reads Rd (the value being stored).
READS_RD = frozenset({Op.STO})


class Instr(NamedTuple):
    """A decoded instruction. ``imm`` is a signed 16-bit value."""

    op: int
    typ: int = Typ.U32
    rd: int = 0
    ra: int = 0
    rb: int = 0
    imm: int = 0
    tsc: int = TSC_FULL

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"{Op(self.op).name}.{Typ(self.typ).name} rd={self.rd} ra={self.ra} "
            f"rb={self.rb} imm={self.imm} tsc={self.tsc:04b}"
        )


# ---------------------------------------------------------------------------
# Instruction-word packing (Fig. 3), parameterised by register-field width.
# ---------------------------------------------------------------------------

def reg_bits(regs_per_thread: int) -> int:
    return max(1, (regs_per_thread - 1).bit_length())


def iw_bits(regs_per_thread: int) -> int:
    """Total IW width: 4 + 6 + 2 + 3*RB + 16 — 40/43/46 bits for 16/32/64
    registers per thread (§5.4).  Bit 0 of Fig. 3 is spare and not counted."""
    return 4 + 6 + 2 + 3 * reg_bits(regs_per_thread) + 16


def encode_word(ins: Instr, regs_per_thread: int) -> int:
    rb_ = reg_bits(regs_per_thread)
    for r in (ins.rd, ins.ra, ins.rb):
        if not 0 <= r < (1 << rb_):
            raise ValueError(f"register {r} out of range for {regs_per_thread} regs")
    imm = ins.imm & 0xFFFF
    w = imm << 1
    pos = 17
    w |= (ins.rb & ((1 << rb_) - 1)) << pos
    pos += rb_
    w |= (ins.ra & ((1 << rb_) - 1)) << pos
    pos += rb_
    w |= (ins.rd & ((1 << rb_) - 1)) << pos
    pos += rb_
    w |= (ins.typ & 0x3) << pos
    pos += 2
    w |= (ins.op & 0x3F) << pos
    pos += 6
    w |= (ins.tsc & 0xF) << pos
    return w


def decode_word(word: int, regs_per_thread: int) -> Instr:
    rb_ = reg_bits(regs_per_thread)
    imm = (word >> 1) & 0xFFFF
    if imm & 0x8000:  # sign-extend
        imm -= 0x10000
    pos = 17
    rbv = (word >> pos) & ((1 << rb_) - 1)
    pos += rb_
    rav = (word >> pos) & ((1 << rb_) - 1)
    pos += rb_
    rdv = (word >> pos) & ((1 << rb_) - 1)
    pos += rb_
    typ = (word >> pos) & 0x3
    pos += 2
    op = (word >> pos) & 0x3F
    pos += 6
    tsc = (word >> pos) & 0xF
    return Instr(op=op, typ=typ, rd=rdv, ra=rav, rb=rbv, imm=imm, tsc=tsc)
