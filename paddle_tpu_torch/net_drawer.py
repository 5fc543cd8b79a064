"""Program graph drawing (counterpart of ``paddle_tpu/net_drawer.py``): the
user-facing ``draw_graph`` and a command line over a saved program,
``python -m paddle_tpu_torch.net_drawer program.json --output g.dot``,
both on top of ``debugger.draw_block_graphviz``."""

import argparse
import json

from .debugger import draw_block_graphviz
from .framework import default_main_program, default_startup_program

__all__ = ["draw_graph"]


def draw_graph(startup_program=None, main_program=None, path="graph.dot",
               startup_path=None, render=False, **kwargs):
    """Write graphviz dot for the main (and optionally the startup)
    program; rendered to an image only with ``render`` and a ``dot``
    binary."""
    if main_program is None:
        main_program = default_main_program()
    out = draw_block_graphviz(main_program.global_block(), path=path,
                              render=render)
    if startup_program is not None or startup_path:
        if startup_program is None:
            startup_program = default_startup_program()
        if not startup_path:
            startup_path = path + ".startup.dot"
        draw_block_graphviz(startup_program.global_block(),
                            path=startup_path, render=render)
    return out


def main():
    p = argparse.ArgumentParser(description="draw a saved Program as dot")
    p.add_argument("program", help="JSON ProgramDesc file "
                   "(Program.to_json / save_train_program output)")
    p.add_argument("--output", default="graph.dot")
    p.add_argument("--render", action="store_true")
    args = p.parse_args()
    from .framework import Program

    with open(args.program) as f:
        payload = json.load(f)
    d = payload.get("program") or payload.get("main") or payload
    prog = Program.from_dict(d)
    out = draw_graph(main_program=prog, path=args.output,
                     render=args.render)
    print(out)


if __name__ == "__main__":
    main()
