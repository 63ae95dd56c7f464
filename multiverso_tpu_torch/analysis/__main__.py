import sys

from multiverso_tpu_torch.analysis.cli import main

# guarded: importing the module (a walk of the package) must not run the
# CLI, only ``python -m multiverso_tpu_torch.analysis`` does
if __name__ == "__main__":
    sys.exit(main())
