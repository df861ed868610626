"""setup_s: seconds from process start to the first timed step: the
imports, the CUDA context, the inputs made on the card, the kernel
library's load (its build on a checkout's first run), the warm-up
steps, and on four cards the spawn of the ranks and NCCL's set-up."""


def read(run):
    return run.setup_s
