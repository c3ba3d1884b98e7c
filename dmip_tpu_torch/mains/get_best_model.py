"""Report the best trials of a grid-search results tree.

Port of ``mains/get_best_model.py``: walks ``--src_dir``, reads each
``results.csv``, recovers the trial's hyper-params from its path and
prints the best trials by mean KL, reverse KL, |NLL difference| and
score-MSE (``gridsearch.traverse_subfolders``).  Reads files only; no
device.

Usage: python -m dmip_tpu_torch.mains.get_best_model --src_dir grid_search_results/linear \
          [--exclude substr1,substr2]
"""

from __future__ import annotations

from ..gridsearch import main

if __name__ == "__main__":
    main()
