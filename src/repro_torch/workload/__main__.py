"""``python -m repro_torch.workload`` — the trace-generator CLI."""
import sys

from .generator import main

if __name__ == "__main__":
    sys.exit(main())
