"""``python -m lanczos_tpu_torch`` — command-line entry point (see cli.py)."""

from .cli import main

if __name__ == "__main__":
    main()
