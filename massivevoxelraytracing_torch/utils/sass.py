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

import hashlib
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


def nvcc_release() -> str:
    """The build line of `nvcc --version` (the compiler that made the SASS)."""
    from .cuda_build import nvcc_path

    out = subprocess.run([nvcc_path(), "--version"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[-1]


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


def _jump(instr: str):
    """_target, and also the target of a branch on a predicate operand
    (`BRA P3, 0x..`, `BRA.U !UP0, 0x..`) and of a CALL: the reading of
    loops and lane_split (loop_body keeps _target's)."""
    t = _target(instr)
    if t is not None:
        return t
    m = re.search(r"\bCALL\.\S+\s+(0x[0-9a-f]+)", instr)
    if m:
        return int(m.group(1), 16)
    m = re.search(r"\bBRA(?:\.\S+)?\s+!?U?P[T0-6],\s*(0x[0-9a-f]+)", instr)
    return int(m.group(1), 16) if m else None


def _where(instrs: list) -> dict:
    """{address or label: instruction index}."""
    where = {}
    for k, (addr, _text, labels) in enumerate(instrs):
        where[addr] = k
        for lab in labels:
            where[lab] = k
    return where


def _last_exit(instrs: list) -> int:
    """The index of the body's end: its last EXIT; but where that EXIT is
    predicated (a loop that leaves by it, its branch back after it), the
    instruction before the first subroutine a CALL enters or before the
    closing branch to itself, whichever comes first past that EXIT."""
    exits = [k for k, (_a, text, _l) in enumerate(instrs) if re.search(r"\bEXIT\b", text)]
    if not exits:
        return len(instrs)
    last = exits[-1]
    if not instrs[last][1].startswith("@"):
        return last
    where = _where(instrs)
    ends = [where[_jump(text)] for _a, text, _l in instrs
            if re.search(r"\bCALL\b", text) and _jump(text) in where]
    ends += [k for k, (addr, text, _l) in enumerate(instrs)
             if re.search(r"\bBRA\b", text) and where.get(_jump(text)) == k]
    past = [k - 1 for k in ends if k > last]
    return min(past) if past else last


def loops(instrs: list) -> list:
    """The spans (first, last instruction index) that the backward branches
    before the last EXIT close, one a loop (the widest where several
    branches share a head), in address order of their heads."""
    where = _where(instrs)
    spans = {}
    for k, (_addr, text, _labels) in enumerate(instrs[:_last_exit(instrs) + 1]):
        if not re.search(r"\bBRA\b", text):
            continue
        start = where.get(_jump(text))
        if start is not None and start < k:
            spans[start] = max(spans.get(start, k), k)
    return sorted(spans.items())


def loop_body(instrs: list) -> list:
    """The instructions of the outermost loop (the longest span a backward
    branch before the last EXIT closes). Raises if the kernel has none."""
    where = _where(instrs)
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


def lane_split(instrs: list, grid_stride: bool) -> tuple:
    """A lane's instructions split by how often a warp runs them: (those it
    runs once, [each loop's own instructions, outside the loops nested in
    it], [each loop's guard: the instructions around it that the loop's
    earliest forward branch past it skips, a walk's start and its hit's
    decode, which a warp whose lanes all miss the walk's node skips]), the
    loops in address order. The lane's body is the kernel before its end
    (_last_exit) or, for a kernel that runs its lanes in a grid-stride
    loop, that (outermost) loop's body. A guard's search starts at the
    enclosing loop's head or past the guard before it."""
    spans = loops(instrs)
    first, last = 0, min(_last_exit(instrs), len(instrs) - 1)
    if grid_stride:
        if not spans:
            raise ValueError("no grid-stride loop in this kernel")
        first, last = max(spans, key=lambda s: s[1] - s[0])
        spans = [s for s in spans if s != (first, last)]
    inner = [s for s in spans if first <= s[0] and s[1] <= last]
    where = _where(instrs)
    guards = []
    for lo_k, hi_k in inner:
        outer = [s for s in inner if s[0] < lo_k and hi_k < s[1]]
        lim = (min(outer, key=lambda s: s[1] - s[0]) if outer else (first, last))
        start = max([lim[0]] + [g[1] + 1 for g in guards if g is not None and g[1] < lo_k])
        skips = [(k, where[_jump(t)]) for k, (_a, t, _l) in enumerate(instrs)
                 if start <= k < lo_k and re.search(r"\bBRA\b", t)
                 and where.get(_jump(t), -1) > hi_k and where[_jump(t)] <= lim[1]]
        guards.append((min(skips)[0] + 1, min(skips)[1] - 1) if skips else None)
    owner = {}
    for k in range(first, last + 1):
        hold = [(s[1] - s[0], ("loop", j)) for j, s in enumerate(inner) if s[0] <= k <= s[1]]
        hold += [(g[1] - g[0], ("guard", j)) for j, g in enumerate(guards)
                 if g is not None and g[0] <= k <= g[1]]
        owner[k] = min(hold)[1] if hold else None
    text = [t for _a, t, _l in instrs]
    return ([text[k] for k, o in owner.items() if o is None],
            [[text[k] for k, o in owner.items() if o == ("loop", j)] for j in range(len(inner))],
            [[text[k] for k, o in owner.items() if o == ("guard", j)]
             for j in range(len(inner))])


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


# nvcc names a source's anonymous namespace after a hash that follows the
# path it was built at: _ZN<n>_GLOBAL__N__<hash>_<n>_<stem>_cu_<hash8><rest>
_ANON = re.compile(r"^_ZN\d+_GLOBAL__N__[0-9a-f]+_\d+_(\w+?)_cu_[0-9a-f]{8}(.*)$")


def source_key(name: str) -> str:
    """A kernel's mangled name as "<source>.cu:<the rest>", without the
    hashes of the path it was built at (a name outside an anonymous
    namespace as it is)."""
    m = _ANON.match(name)
    return f"{m.group(1)}.cu:{m.group(2)}" if m else name


def digests(funcs: dict) -> dict:
    """{source_key: the first 16 hex digits of the sha256 of the kernel's
    instructions, one a line, without their addresses} of a listing's
    kernels: equal digests, equal machine code."""
    return {source_key(f): hashlib.sha256("\n".join(t for _a, t, _l in instrs).encode())
            .hexdigest()[:16] for f, instrs in funcs.items()}


# The SM's pipes: a SASS opcode (its name before the first ".") -> the
# pipe_probe class it belongs to (ops/probes.PIPE_CLASSES); I2FP is the
# int-to-float convert the probes issue. Opcodes outside the table (branches,
# moves, the uniform datapath, PRMT, FLO, ...) count toward the issue floor
# only.
PIPE_CLASS = {"FADD": "FADD/FMUL", "FMUL": "FADD/FMUL", "FFMA": "FADD/FMUL",
              "FMNMX": "FMNMX", "FSETP": "FSETP", "ISETP": "ISETP", "LOP3": "LOP3",
              "SHF": "SHF", "SEL": "SEL", "FSEL": "FSEL", "IADD3": "IADD3", "IMAD": "IMAD",
              "POPC": "POPC", "I2FP": "I2F", "I2F": "I2F", "F2I": "F2I"}
# Which classes share a pipe (their clocks add) and which issue side by
# side, as the card measured them (scripts/common.pipe_rates and the
# probes' own loops, an NVIDIA H100 80GB HBM3 at 700 W; PERF.md section 6):
# the integer, logic, compare, min / max, select and int-to-float classes,
# each 2 warp instructions an SM a clock, share one pipe; FADD / FMUL (4 a
# clock) and IMAD (2 a clock) have pipes of their own; POPC and F2I (0.5 a
# clock) share one. (In pipe_probe's pairs FADD / FMUL beside LOP3, FMNMX
# or IMAD took near their clocks added, but the minmax and cmpsel
# constructs run FADD beside FMNMX / FSETP / FSEL faster than that: a floor
# must stay below every loop, so FADD / FMUL keep a pipe of their own.)
PIPES = {"FMNMX": "alu", "FSETP": "alu", "ISETP": "alu", "LOP3": "alu", "SHF": "alu",
         "SEL": "alu", "FSEL": "alu", "IADD3": "alu", "I2F": "alu", "FADD/FMUL": "fp32",
         "IMAD": "imad", "POPC": "xu", "F2I": "xu"}


def class_counts(body: list) -> dict:
    """{pipe_probe class or the opcode outside them: instructions} of a loop
    body."""
    out = {}
    for text in body:
        base = _opcode(text)[1].split(".")[0]
        key = PIPE_CLASS.get(base, base)
        out[key] = out.get(key, 0) + 1
    return out


def pipe_floor(body: list, rates: dict, pipes: dict = PIPES, repeats: int = 1,
               loops: tuple = ()) -> dict:
    """The clocks an SM needs a warp-repeat of the loop on its busiest pipe:
    each class's instructions a repeat over its rate (warp instructions an
    SM issues a clock, `rates`, from pipe_probe alone), summed over the
    classes that share a pipe (`pipes`). `loops`: (instructions, times a
    warp runs them a repeat) of loops run beside the body (a walk's slots,
    as a warp runs them), added to its counts. Returns {"clocks", "pipe" (the
    busiest), "by_pipe" {pipe: clocks}, "issue_clocks" (all instructions a
    repeat over the SM's 4 a clock), "unclassified" (instructions a repeat
    that count toward the issue only), "instructions" (a repeat)}."""
    counts = class_counts(body)
    total = float(len(body))
    for instrs, times in loops:
        total += times * len(instrs)
        for key, n in class_counts(instrs).items():
            counts[key] = counts.get(key, 0) + times * n
    by_pipe = {}
    other = 0
    for key, n in counts.items():
        if key in rates and key in pipes:
            by_pipe[pipes[key]] = by_pipe.get(pipes[key], 0.0) + n / repeats / rates[key]
        else:
            other += n
    pipe = max(by_pipe, key=by_pipe.get) if by_pipe else None
    return dict(clocks=by_pipe.get(pipe, 0.0), pipe=pipe, by_pipe=by_pipe,
                issue_clocks=total / repeats / 4, unclassified=other / repeats,
                instructions=total / repeats)
