"""CLI entry (reference Applications/LogisticRegression/src/main.cpp:8-12):

    python -m multiverso_tpu_torch.models.logreg.main <config_file> \
        [-platform cuda|cpu]

Trains on the card unless ``-platform cpu`` (or ``platform=cpu`` in the
config file) asks for the CPU; then tests when the config names a test
file.
"""

from __future__ import annotations

import sys

from multiverso_tpu_torch.models.logreg.configure import Configure
from multiverso_tpu_torch.models.logreg.logreg import LogReg
from multiverso_tpu_torch.utils.log import Log

USAGE = ("usage: python -m multiverso_tpu_torch.models.logreg.main "
         "<config_file> [-platform cuda|cpu]")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) not in (1, 3) or (len(argv) == 3 and argv[1] != "-platform"):
        Log.Error(USAGE)
        return 1
    config = Configure.from_file(argv[0])
    if len(argv) == 3:
        config.platform = argv[2]
    lr = LogReg(config)
    try:
        lr.Train()
        if lr.config.test_file:
            lr.Test()
    finally:
        lr.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
