"""``python -m repro_torch.telemetry summarize|diff run.jsonl``."""
import sys

from repro_torch.telemetry.summarize import main

if __name__ == "__main__":
    sys.exit(main())
