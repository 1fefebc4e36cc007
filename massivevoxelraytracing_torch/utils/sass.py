"""Instruction counts of the built kernels' loops, read from their SASS.

`cuobjdump -sass` on build/torch_kernels/libhako_torch.so lists each
kernel's machine code. A probe kernel (csrc/hako_probes.cu) repeats its
construct in an outer loop (`#pragma unroll 1`) whose body holds a fixed
number of repeats, so that body's instructions over the repeats a pass
are what one repeat issues. The body is the span of the kernel's
outermost backward branch, among those before its last EXIT (past it the
compiler places out-of-line slow paths, a divergent warp's WARPSYNC or an
mbarrier wait's retry, which branch back into the body without being
loops of it). Its dependent chain is the longest path
through the body of instructions that read a register or predicate that
an earlier instruction of the body wrote: the instructions one repeat
must wait on in turn, whatever the issue rate.
"""

from __future__ import annotations

import os
import re
import subprocess

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_REG = re.compile(r"\bU?P[0-6]\b|\bU?R\d+\b")
# opcodes whose first two operands are both written (a predicate pair, or a
# predicate and a register)
_TWO_DESTS = ("ISETP", "FSETP", "DSETP", "HSETP2", "PLOP3", "SHFL", "VOTE")
# opcodes that write nothing (their first operand is read)
_NO_DEST = ("ST", "STG", "STS", "STL", "RED", "BRA", "EXIT", "RET", "BAR",
            "BSYNC", "BSSY", "WARPSYNC", "NOP", "CALL", "MEMBAR", "ERRBAR",
            "DEPBAR", "CCTL", "YIELD")


def cuobjdump_path() -> str:
    from .cuda_build import nvcc_path

    return os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")


def dump(lib_path: str) -> str:
    """The library's SASS; raises if cuobjdump fails."""
    out = subprocess.run([cuobjdump_path(), "-sass", lib_path],
                         capture_output=True, text=True, check=True)
    return out.stdout


def functions(text: str) -> dict:
    """{mangled kernel name: [(address, instruction, labels)]} of a SASS
    listing."""
    funcs = {}
    cur = None
    labels = []
    for line in text.splitlines():
        if "Function :" in line:
            cur = funcs.setdefault(line.split("Function :", 1)[1].strip(), [])
            labels = []
            continue
        if cur is None:
            continue
        m = _LABEL.match(line)
        if m:
            labels.append(m.group(1))
            continue
        m = _INSTR.search(line)
        if m and not m.group(2).startswith("0x"):
            cur.append((int(m.group(1), 16), m.group(2).strip(), tuple(labels)))
            labels = []
    return funcs


def _target(instr: str):
    m = re.search(r"`\((\.L_x_\d+)\)", instr)
    if m:
        return m.group(1)
    m = re.search(r"\bBRA(?:\.\S+)?\s+(0x[0-9a-f]+)", instr)
    return int(m.group(1), 16) if m else None


def loop_body(instrs: list) -> list:
    """The instructions of the outermost loop (the longest span a backward
    branch before the last EXIT closes). Raises if the kernel has none."""
    where = {}
    for k, (addr, _text, labels) in enumerate(instrs):
        where[addr] = k
        for lab in labels:
            where[lab] = k
    last_exit = max((k for k, (_a, text, _l) in enumerate(instrs)
                     if re.search(r"\bEXIT\b", text)), default=len(instrs))
    best = None
    for k, (_addr, text, _labels) in enumerate(instrs[:last_exit]):
        if not re.search(r"\bBRA\b", text):
            continue
        start = where.get(_target(text))
        if start is not None and start < k and (best is None
                                                or k - start > best[1] - best[0]):
            best = (start, k)
    if best is None:
        raise ValueError("no loop in this kernel")
    return [text for _addr, text, _labels in instrs[best[0]:best[1] + 1]]


def _opcode(text: str) -> tuple:
    """(guard predicate or None, opcode, operand strings)."""
    guard = None
    if text.startswith("@"):
        guard, text = text.split(None, 1)
        guard = guard.lstrip("@!")
    parts = text.split(None, 1)
    ops = [o.strip() for o in parts[1].split(",")] if len(parts) > 1 else []
    return guard, parts[0], ops


def chain_length(body: list) -> int:
    """The longest path of dependent instructions through the body: each
    instruction's depth is one more than the deepest instruction of the
    body that wrote a register or predicate it reads (R2P's destination
    PR writes every predicate)."""
    depth = {}
    longest = 0
    for text in body:
        guard, opcode, ops = _opcode(text)
        base = opcode.split(".")[0]
        n_dest = 0 if base in _NO_DEST else (
            2 if opcode.startswith(_TWO_DESTS) else 1)
        dests = [r for o in ops[:n_dest]
                 for r in ([f"P{j}" for j in range(7)] if o == "PR" else _REG.findall(o))]
        srcs = [r for o in ops[n_dest:] for r in _REG.findall(o)]
        if guard:
            srcs.append(guard)
        d = 1 + max((depth.get(r, 0) for r in srcs), default=0)
        longest = max(longest, d)
        for r in dests:
            depth[r] = d
    return longest


def kernel_name(funcs: dict, name: str, *targs) -> str:
    """The mangled name of kernel `name` instantiated with the integer or
    bool template arguments `targs` (in order; none for a kernel that is
    not a template)."""
    args = "".join(f"L{'b' if isinstance(a, bool) else 'i'}{int(a)}E" for a in targs)
    pat = re.compile(rf"{re.escape(name)}I{args}E" if targs else
                     rf"{re.escape(name)}E")
    hits = [f for f in funcs if pat.search(f)]
    if len(hits) != 1:
        raise ValueError(f"{len(hits)} kernels match {name}<{targs}>")
    return hits[0]


def loop_counts(funcs: dict, name: str, *targs, repeats: int = 1) -> dict:
    """The loop body of kernel name<targs>: its instructions and its
    dependent chain, in all and per repeat (the body holds `repeats`)."""
    body = loop_body(funcs[kernel_name(funcs, name, *targs)])
    chain = chain_length(body)
    return dict(body=len(body), chain=chain, per_repeat=len(body) / repeats,
                chain_per_repeat=chain / repeats)
