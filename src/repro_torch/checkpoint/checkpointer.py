"""Fault-tolerant checkpointing of trees of tensors (port of
``repro/checkpoint/checkpointer.py``).

  * atomic writes (tmp dir + os.replace): a crash mid-save never corrupts
    the latest checkpoint;
  * step-tagged directories + retention policy;
  * corrupted-checkpoint quarantine on restore (falls back to the previous
    valid step);
  * resume metadata (step, simulated time, campaign identity).

The leaves are written host-side with ``torch.save`` (dtype and bits as they
are, bfloat16 included) and the tree's containers, leaves left out, beside
them; ``restore`` puts the leaves on the device the caller names. The
format is the port's own: a checkpoint of the port is not one of the
reference, and the other way round.
"""

from __future__ import annotations

import json
import os
import pickle
import re
import shutil
import tempfile
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_like, tree_map

_STEP = re.compile(r"step_\d+")


def _json_safe(obj):
    """Metadata often carries numpy scalars (simulated times, round indices);
    coerce them so ``json.dump`` never rejects a checkpoint save."""
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    raise TypeError(f"metadata value of type {type(obj).__name__} "
                    f"is not JSON-serialisable")


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def save(self, step: int, tree: Any, metadata: Optional[dict] = None) -> str:
        """Atomic save: write to tmp, then rename into place."""
        leaves = [x.detach().cpu() for x in tree_leaves(tree)]
        final = self._step_dir(step)
        tmp = tempfile.mkdtemp(prefix=".tmp_ckpt_", dir=self.directory)
        try:
            torch.save(leaves, os.path.join(tmp, "leaves.pt"))
            with open(os.path.join(tmp, "treedef.pkl"), "wb") as f:
                pickle.dump(tree_map(lambda _: None, tree), f)
            meta = dict(metadata or {})
            meta.update({"step": step, "time": time.time(), "n_leaves": len(leaves)})
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f, default=_json_safe)
            # commit marker makes partially-written dirs detectable
            with open(os.path.join(tmp, "COMMITTED"), "w") as f:
                f.write("ok")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()
        return final

    # ------------------------------------------------------------------
    def steps(self) -> list[int]:
        """Committed steps, oldest first (a quarantined ``step_N.corrupt`` is
        not one: the reference would fail to parse its name)."""
        out = []
        for name in os.listdir(self.directory):
            if _STEP.fullmatch(name) and os.path.exists(
                    os.path.join(self.directory, name, "COMMITTED")):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def _gc(self):
        steps = self.steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------------
    def restore(self, step: Optional[int] = None, device="cpu") -> tuple[Any, dict]:
        """Restore (tree, metadata), the leaves on ``device``. Quarantines
        corrupt dirs and falls back to the previous step."""
        candidates = self.steps() if step is None else [step]
        for s in reversed(candidates):
            d = self._step_dir(s)
            try:
                # the containers were pickled by ``save`` of this class
                with open(os.path.join(d, "treedef.pkl"), "rb") as f:
                    skeleton = pickle.load(f)
                leaves = torch.load(os.path.join(d, "leaves.pt"), map_location=device,
                                    weights_only=True)
                with open(os.path.join(d, "meta.json")) as f:
                    meta = json.load(f)
                if len(leaves) != len(tree_leaves(skeleton)):
                    raise ValueError(f"{d}: {len(leaves)} leaves for a tree of "
                                     f"{len(tree_leaves(skeleton))}")
                return tree_like(skeleton, leaves), meta
            except Exception:
                quarantine = d + ".corrupt"
                try:
                    os.replace(d, quarantine)
                except OSError:
                    pass
                continue
        raise FileNotFoundError(f"no restorable checkpoint in {self.directory}")

    def restore_or_none(self, device="cpu"):
        try:
            return self.restore(device=device)
        except FileNotFoundError:
            return None
