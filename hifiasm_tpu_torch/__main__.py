"""`python -m hifiasm_tpu_torch` == the `hifiasm-tpu-torch` console script."""
import sys

from hifiasm_tpu_torch.cli import main

sys.exit(main())
