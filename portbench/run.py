"""python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>: one run of one cell of BENCHMARK.json; the last line of
standard output is the result (README.md)."""
import time

_T_START = time.perf_counter()

if __name__ == "__main__":
    import sys

    from portbench.harness import main
    sys.exit(main(t_start=_T_START))
