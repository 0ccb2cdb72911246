"""``python -m autodist_tpu_torch.launch [--spec r.yml] script.py args...``:
one process per node of the resource spec, each with its identity env
(see :func:`autodist_tpu_torch.runtime.coordinator.launch_cli`)."""
import sys

from autodist_tpu_torch.runtime.coordinator import launch_cli

if __name__ == '__main__':
    sys.exit(launch_cli())
