"""``python3 -m portbench --workload <name> --seed <n> --seconds <s>
--trace <0|1>``: one run of one cell (``run.py``)."""

import sys

from portbench.run import main

sys.exit(main())
