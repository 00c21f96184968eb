"""A mesh rehearsal's worker process: `ekbench.worker` with the fault of
`ekbench.tests.rehearse` planted first (--fault=NAME before its own
arguments)."""
import sys

from ekbench import worker
from ekbench.tests.rehearse import plant

if __name__ == "__main__":
    argv = sys.argv[1:]
    fault = ""
    if argv and argv[0].startswith("--fault="):
        fault = argv.pop(0).split("=", 1)[1]
    import torch

    torch.set_num_threads(2)
    plant(fault)
    sys.exit(worker.main(argv))
