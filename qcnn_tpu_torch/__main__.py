"""``python -m qcnn_tpu_torch``: the command-line entry points (``cli.py``)."""

from qcnn_tpu_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
