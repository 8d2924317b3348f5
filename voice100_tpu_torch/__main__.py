"""``python -m voice100_tpu_torch fit|validate|test|predict --config ...``:
the port's training CLI (the counterpart of ``python -m voice100_tpu``)."""

from .training.cli import cli_main

if __name__ == "__main__":
    cli_main()
