"""Command line interface: `python -m ryujin_tpu [config.yaml]`.

Analog of /root/reference/source/main.cc:59-128: run the solver on a
configuration file; if the file does not exist, write a template
configuration (per equation with `--equation`) and exit.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="ryujin_tpu",
        description="Invariant-domain-preserving solver for hyperbolic "
        "systems of conservation laws",
    )
    parser.add_argument("config", nargs="?", default="ryujin.yaml",
                        help="YAML configuration file")
    parser.add_argument("--equation", default="euler",
                        help="equation for a generated template config")
    parser.add_argument("--dimension", type=int, default=2)
    parser.add_argument("--quiet", action="store_true")
    args = parser.parse_args(argv)

    from .config import Config

    if not os.path.exists(args.config):
        cfg = Config()
        cfg.equation.equation = args.equation
        cfg.equation.dimension = args.dimension
        cfg.save(args.config)
        print(
            f"configuration file '{args.config}' not found - "
            "a template has been written; edit it and rerun"
        )
        return 1

    cfg = Config.load(args.config)
    from .driver import TimeLoop
    from .utils.compile_cache import configure_compile_cache

    configure_compile_cache()

    loop = TimeLoop(cfg)
    print(f"[ryujin_tpu] equation: {cfg.equation.equation}, "
          f"dim {cfg.equation.dimension}, "
          f"{loop.packed.n_nodes} dofs, backend {loop.backend}")
    loop.run(quiet=args.quiet)
    return 0


if __name__ == "__main__":
    sys.exit(main())
