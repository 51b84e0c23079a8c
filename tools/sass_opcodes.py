#!/usr/bin/env python3
"""Opcode counts of the port's compiled CUDA kernels, from their SASS.

    python3 tools/sass_opcodes.py SOURCE [--src SRC_DIR] [--kernel REGEX]
                                  [--ops OP,OP] [--dump FILE] [--against SRC_DIR]

Builds ``csrc/SOURCE.cu`` of the ``repro_torch`` under ``SRC_DIR`` (default:
this checkout's ``src``) if its library is missing, runs ``cuobjdump -sass``
on the library and, for each kernel whose demangled name matches
``--kernel``, prints one JSON line: the name, its instruction count and the
count of each opcode in ``--ops`` (an opcode counts with its modifiers, as
``VIMNMX.S16x2``, and under its base name, as ``VIMNMX``), or of every
opcode without ``--ops``.  ``--dump`` writes those kernels' SASS to a file.
``--against`` names another tree (a parent commit's ``src``): each line
then also says which of that tree's kernels has the very same SASS, if any
(``"same_as"``, null for none), so a kernel whose source was reworded can
be shown to compile as before.
Needs the CUDA toolkit (``cuobjdump``, ``cu++filt``), not a card.  Imports
nothing of JAX.
"""
import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FUNCTION = re.compile(r"^\s*Function : (\S+)")
TEXT = re.compile(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);")
INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*(?:\.[A-Za-z0-9_]+)*)")


def tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", name)


def kernels(sass: str) -> dict[str, list[str]]:
    """Each function's SASS lines, by mangled name."""
    out, name = {}, None
    for line in sass.splitlines():
        m = FUNCTION.match(line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name is not None:
            out[name].append(line)
    return out


def library_sass(source: str, src: str) -> dict[str, list[str]]:
    """Build ``csrc/source.cu`` under ``src`` if needed; each of its
    kernels' SASS lines by mangled name."""
    sys.path.insert(0, os.path.abspath(src))
    for mod in [m for m in sys.modules if m.split(".")[0] == "repro_torch"]:
        del sys.modules[mod]
    from repro_torch.kernels import _build
    _build.build((source,))
    lib = _build.library_path(source)
    sys.path.remove(os.path.abspath(src))
    sass = subprocess.run([tool("cuobjdump"), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    funcs = kernels(sass)
    if not funcs:
        raise SystemExit(f"sass_opcodes: no function in cuobjdump -sass {lib} "
                         f"({len(sass)} characters of output)")
    return funcs


def demangle(names: list[str]) -> list[str]:
    out = subprocess.run([tool("cu++filt")], input="\n".join(names) + "\n",
                         capture_output=True, text=True, check=True).stdout.splitlines()
    return out if len(out) == len(names) else list(names)


def instructions(lines: list[str]) -> list[str]:
    """The instructions' text (opcode and operands), in order."""
    return [" ".join(m.group(1).split()) for m in map(TEXT.search, lines) if m]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("source")
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--kernel", default="")
    ap.add_argument("--ops", default="")
    ap.add_argument("--dump")
    ap.add_argument("--against")
    args = ap.parse_args()
    funcs = library_sass(args.source, args.src)
    names = demangle(list(funcs))
    other = {}
    if args.against:
        theirs = library_sass(args.source, args.against)
        for name, lines in zip(demangle(list(theirs)), theirs.values()):
            other.setdefault(tuple(instructions(lines)), name)
    want = [o for o in args.ops.split(",") if o]
    dump = []
    matched = 0
    for (mangled, lines), name in zip(funcs.items(), names):
        if not (re.search(args.kernel, name) or re.search(args.kernel, mangled)):
            continue
        matched += 1
        counts = collections.Counter()
        n = 0
        for line in lines:
            m = INSTR.search(line)
            if m:
                n += 1
                counts[m.group(1)] += 1
                if "." in m.group(1):
                    counts[m.group(1).split(".")[0]] += 1
        shown = {o: counts.get(o, 0) for o in want} if want else dict(counts.most_common())
        row = {"source": args.source, "kernel": name, "instructions": n, "ops": shown}
        if args.against:
            row["same_as"] = other.get(tuple(instructions(lines)))
        print(json.dumps(row), flush=True)
        dump += [f"Function : {mangled}  // {name}", *lines]
    if not matched:
        print(f"sass_opcodes: no kernel of {len(funcs)} matches {args.kernel!r}; "
              f"the first: {names[:3]}", file=sys.stderr)
    if args.dump:
        with open(args.dump, "w") as f:
            f.write("\n".join(dump) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
