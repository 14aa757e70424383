"""Auto-layout training entry point (port of ``tools/auto.py``)::

    python -m fleetx_tpu_torch.tools.auto \\
        -c fleetx_tpu/configs/nlp/gpt/auto/pretrain_gpt_1.3B_single_card.yaml \\
        [-o Key.Sub=v ...] [--device cuda|cpu]

``tools/train.py``'s CLI with the layout planner on
(``train.main(argv, auto_layout=True)``, as the JAX tool calls
``train.main(auto_layout=True)``): ``parallel/auto_layout.suggest_layout``
picks the ``Distributed`` degrees before the batch derivations, for the
world of the gang (``FLEETX_NUM_PROCESSES``, 1 outside a gang), unless the
YAML pins explicit ones. The log names the resolved degrees and the planner's budget: the
YAML's ``Distributed.auto_layout.hbm_gb``, else the card's memory. As in
the JAX package, the engine is ``EagerEngine``. It runs on ``cuda`` unless
``--device cpu`` is given.
"""

from __future__ import annotations

import sys
from typing import Optional


def main(argv: Optional[list] = None) -> int:
    from fleetx_tpu_torch.tools import train

    return train.main(argv, auto_layout=True)


if __name__ == "__main__":
    sys.exit(main())
