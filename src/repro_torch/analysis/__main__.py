"""``python -m repro_torch.analysis`` — run the AST lint gate (RK001-RK003)."""
import sys

from .lint import main

if __name__ == "__main__":
    sys.exit(main())
