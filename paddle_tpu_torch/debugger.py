"""Program inspection (counterpart of ``paddle_tpu/debugger.py``): a
pseudo-code printer and a graphviz export.

``draw_block_graphviz`` writes the ``.dot`` text itself (op nodes as
boxes, variable nodes as ellipses, parameters filled), the same text as the
JAX package's, and runs the ``dot`` binary only when ``render=True`` asks
for an image and the binary exists."""

import shutil
import subprocess

from .core import dtype_name
from .framework import Parameter, default_main_program

__all__ = ["pprint_program_codes", "pprint_block_codes",
           "draw_block_graphviz"]


def _fmt_attr(v):
    if isinstance(v, float):
        return "%.6g" % v
    if isinstance(v, (list, tuple)) and len(v) > 8:
        return "[%s, ...x%d]" % (", ".join(map(str, v[:4])), len(v))
    return repr(v)


def pprint_block_codes(block, show_backward=False):
    """One block as pseudo-code text."""
    lines = ["// block %d (parent %d)" % (block.idx, block.parent_idx)]
    for var in block.vars.values():
        kind = "param" if isinstance(var, Parameter) else "var"
        extra = " persistable" if getattr(var, "persistable", False) \
            and kind != "param" else ""
        lines.append("%s %s : shape=%s dtype=%s%s" % (
            kind, var.name, tuple(var.shape or ()),
            None if var.dtype is None else dtype_name(var.dtype), extra))
    for op in block.ops:
        if not show_backward and op.type.endswith("_grad"):
            continue
        outs = ", ".join(n for ns in op.outputs.values() for n in ns if n)
        ins = ", ".join(n for ns in op.inputs.values() for n in ns if n)
        attrs = ", ".join("%s=%s" % (k, _fmt_attr(v))
                          for k, v in sorted(op.attrs.items())
                          if not k.startswith("__"))
        lines.append("%s = %s(%s)%s" % (
            outs or "_", op.type, ins,
            "  {%s}" % attrs if attrs else ""))
    return "\n".join(lines) + "\n"


def pprint_program_codes(program=None, show_backward=False):
    """Whole program as text, all blocks."""
    program = program or default_main_program()
    return "\n".join(pprint_block_codes(b, show_backward)
                     for b in program.blocks)


def draw_block_graphviz(block, highlights=None, path="./temp.dot",
                        render=False):
    """Write the block's dataflow as a .dot file.  Op nodes are boxes, var
    nodes
    ellipses, parameters filled; ``highlights`` is a set of var names to
    color.  With ``render=True`` and the ``dot`` binary present, also
    writes ``<path>.png``."""
    highlights = set(highlights or ())
    lines = ["digraph G {", '  rankdir="TB";']

    def vid(name):
        return '"var_%s"' % name

    seen_vars = set()
    for var in block.vars.values():
        seen_vars.add(var.name)
        style = "filled"
        color = "lightblue" if isinstance(var, Parameter) else "white"
        if var.name in highlights:
            color = "orange"
        lines.append(
            '  %s [label="%s\\n%s" shape=ellipse style=%s '
            'fillcolor=%s];' % (vid(var.name), var.name,
                                tuple(var.shape or ()), style, color))
    for i, op in enumerate(block.ops):
        oid = '"op_%d"' % i
        lines.append(
            '  %s [label="%s" shape=box style=filled '
            'fillcolor=lightgrey];' % (oid, op.type))
        for n in op.input_arg_names:
            if not n:
                continue
            if n not in seen_vars:
                seen_vars.add(n)
                lines.append('  %s [label="%s" shape=ellipse];'
                             % (vid(n), n))
            lines.append("  %s -> %s;" % (vid(n), oid))
        for n in op.output_arg_names:
            if not n:
                continue
            if n not in seen_vars:
                seen_vars.add(n)
                lines.append('  %s [label="%s" shape=ellipse];'
                             % (vid(n), n))
            lines.append("  %s -> %s;" % (oid, vid(n)))
    lines.append("}")
    dot = "\n".join(lines) + "\n"
    with open(path, "w") as f:
        f.write(dot)
    if render and shutil.which("dot"):
        subprocess.run(["dot", "-Tpng", path, "-o", path + ".png"],
                       check=False, capture_output=True)
    return path
