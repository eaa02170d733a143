"""Run one cell of the benchmark once:

    python3 port_bench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for.  The last line of standard output is the result (JSON).
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache at a fixed path inside the checkout (the
# program builds its CUDA libraries into build/repro_torch)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / "port_bench" / sub)
if __name__ == "__main__":       # run as a script from a checkout
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))

import torch  # noqa: E402

# torch keeps no pool of CPU threads: the program's host path is one thread
torch.set_num_threads(1)

from port_bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
