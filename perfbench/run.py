"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Run from the root of a checkout that holds the port (``masklab_tpu_torch``)
on a machine with the cards the cell asks for. See ``harness/main.py``."""
import os
import sys

if __name__ == '__main__':
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from perfbench.harness.main import main
    sys.exit(main(sys.argv[1:]))
