"""``python -m empanada_tpu_torch`` runs the command line (``cli.py``)."""

from empanada_tpu_torch.cli import main

if __name__ == "__main__":
    main()
