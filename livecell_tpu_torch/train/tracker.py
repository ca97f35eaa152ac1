"""Experiment tracking behind a thin interface (the port's copy of
livecell_tpu/train/tracker.py).

The reference logs to W&B with a fixed namespaced schema. When the
wandb SDK is not importable the tracker keeps the same schema and
writes JSONL lines under `outputs/runs/<name>.jsonl` instead; nothing is
fetched. Logging is host-side after the step and never blocks the
device.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


def _load_dotenv():
    """Load W&B credentials from .env like the reference trainers;
    python-dotenv is optional."""
    try:
        from dotenv import load_dotenv  # type: ignore

        load_dotenv()
    except ImportError:
        path = ".env"
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if line and not line.startswith("#") and "=" in line:
                        k, v = line.split("=", 1)
                        os.environ.setdefault(k.strip(), v.strip())


class Tracker:
    def __init__(self, enabled: bool, project: str, name: str,
                 config: Optional[Dict] = None,
                 out_dir: str = "outputs/runs"):
        _load_dotenv()
        self.enabled = enabled
        self.name = name
        self._wandb = None
        self._file = None
        if not enabled:
            return
        try:
            import wandb  # type: ignore

            wandb.init(project=project, name=name, config=config or {})
            self._wandb = wandb
            print("W&B initialized")
        except Exception:
            os.makedirs(out_dir, exist_ok=True)
            path = os.path.join(out_dir, f"{name}.jsonl")
            self._file = open(path, "a")
            self._file.write(json.dumps(
                {"event": "init", "project": project, "name": name,
                 "config": config or {}, "time": time.time()}) + "\n")
            self._file.flush()
            print(f"wandb unavailable; logging to {path}")

    def update_config(self, cfg: Dict):
        if self._wandb is not None:
            self._wandb.config.update(cfg)
        elif self._file is not None:
            self._file.write(json.dumps(
                {"event": "config_update", "config": cfg}) + "\n")
            self._file.flush()

    def log(self, metrics: Dict):
        if self._wandb is not None:
            self._wandb.log(metrics)
        elif self._file is not None:
            self._file.write(json.dumps(
                {"event": "log", "time": time.time(), **metrics}) + "\n")
            self._file.flush()

    def log_image(self, key: str, path: str):
        if self._wandb is not None:
            self._wandb.log({key: self._wandb.Image(path)})
        elif self._file is not None:
            self._file.write(json.dumps(
                {"event": "image", "key": key, "path": path}) + "\n")
            self._file.flush()

    def finish(self):
        if self._wandb is not None:
            self._wandb.finish()
        elif self._file is not None:
            self._file.close()
            self._file = None


def check_login() -> bool:
    """W&B credential smoke check."""
    try:
        import wandb  # type: ignore

        wandb.login()
        print(f"Logged in as: {wandb.api.default_entity}")
        return True
    except Exception as e:
        print(f"W&B login unavailable: {e}")
        return False


if __name__ == "__main__":
    # Standalone credential check.
    check_login()
