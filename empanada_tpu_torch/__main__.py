"""``python -m empanada_tpu_torch`` runs the command line (``cli.py``)."""

import torch.distributed as dist

from empanada_tpu_torch.cli import main

if __name__ == "__main__":
    try:
        main()
    finally:
        # a world joined by --coordinator ends with the process
        if dist.is_initialized():
            dist.destroy_process_group()
