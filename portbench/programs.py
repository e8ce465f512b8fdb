"""A configuration's programs and the inputs its jobs get.

A configuration file (``configs/<name>.json``) holds the eGPU knobs and
the programs frozen as instruction words, so the benchmark's workload
does not move when the program's assembler or builders change.  This
module turns them into what the program under test takes (its
``EGPUConfig`` and ``ProgramImage``) and into what the reference takes
(decoded rows and paths), and makes the jobs' shared memory from the
seed on the device, in large draws.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .reference import egpu


@dataclasses.dataclass
class Program:
    """One frozen program of a configuration."""

    index: int
    name: str
    words: np.ndarray        # (n,) uint64 instruction words
    rows: np.ndarray         # (n, 7) decoded fields
    threads: int
    tdx_dim: int
    input_words: int         # words [0, input_words) drawn from the seed
    fixed: np.ndarray        # uint32 words that follow the inputs
    steps: int               # the path's length as the paper suite records
    path: egpu.Path | None = None

    @property
    def init_words(self) -> int:
        return self.input_words + self.fixed.size


def load(doc: dict, names=None) -> tuple[egpu.Core, list[Program]]:
    """The reference core and the programs of a configuration document
    (``names``: a subset, in the file's order), each with its path."""
    core = egpu.Core.from_config(doc)
    out = []
    for p in doc["programs"]:
        if names is not None and p["name"] not in names:
            continue
        words = np.asarray([int(w, 16) for w in p["words"]], np.uint64)
        prog = Program(
            index=len(out), name=p["name"], words=words,
            rows=egpu.decode(words, core.regs_per_thread),
            threads=p["threads"], tdx_dim=p["tdx_dim"],
            input_words=p["input_words"],
            fixed=np.asarray([int(w, 16) for w in p["fixed_words"]],
                             np.uint32),
            steps=p["steps"])
        prog.path = egpu.sequence(core, prog.rows, prog.threads)
        if prog.path.steps != prog.steps:
            raise ValueError(f"{prog.name}: the reference runs "
                             f"{prog.path.steps} steps, the file says "
                             f"{prog.steps}")
        out.append(prog)
    if names is not None and len(out) != len(set(names)):
        raise ValueError(f"unknown programs in {sorted(names)}")
    return core, out


def port_config(doc: dict):
    """The program's ``EGPUConfig`` with the file's knobs."""
    from repro_torch.core.config import CostParams, EGPUConfig
    return EGPUConfig(**doc["config"], cost=CostParams(**doc["cost"]))


def port_image(cfg, prog: Program):
    """The program's ``ProgramImage`` of a frozen program: the decoded
    fields and the words themselves."""
    from repro_torch.core.assembler import ProgramImage
    col = lambda k: np.ascontiguousarray(prog.rows[:, k], np.int32)
    return ProgramImage(cfg=cfg, op=col(0), typ=col(1), rd=col(2),
                        ra=col(3), rb=col(4), imm=col(5), tsc=col(6),
                        words=prog.words.copy(), listing=[],
                        threads_active=prog.threads)


def stream_seed(seed: int, *stream: int) -> int:
    """A 63-bit seed for one named stream of a run's seed."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), *stream])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


class Inputs:
    """The jobs' input words, drawn as float32 standard normals on
    ``device`` by one ``torch.Generator`` per stream, in one draw per
    program and batch, and copied to host buffers that hold each job's
    initial shared memory (inputs, then the program's fixed words)."""

    def __init__(self, device, seed: int, stream: int):
        import torch
        self.torch = torch
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(stream_seed(seed, stream))

    def draw(self, prog: Program, rows: int, out: np.ndarray | None = None
             ) -> np.ndarray:
        """``(rows, prog.init_words)`` uint32 initial shared memory
        (into ``out`` when given, whose fixed words are kept).  On the
        card a new buffer is pinned host memory, which the draw fills by
        one copy; a buffer passed back is filled again in place."""
        torch = self.torch
        if out is None:
            buf = torch.empty((rows, prog.init_words), dtype=torch.int32,
                              pin_memory=self.device.type == "cuda")
            out = buf.numpy().view(np.uint32)
            out[:, prog.input_words:] = prog.fixed
        x = torch.randn((rows, prog.input_words), generator=self.gen,
                        device=self.device, dtype=torch.float32)
        dst = torch.from_numpy(out.view(np.int32))[:, :prog.input_words]
        dst.copy_(x.view(torch.int32))
        return out
