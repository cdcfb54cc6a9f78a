"""Persistent user settings (JAX utils/settings.py, reference
SettingsManager, ultralytics/utils/__init__.py:737-818).

A versioned JSON file in the port's own config directory,
`$XDG_CONFIG_HOME/dedark_yolo_tpu_torch/settings.json` (else
`~/.config/...`), holding datasets_dir, weights_dir, runs_dir and two
toggles. A file whose keys, types or version drift, or that does not parse,
is reset to the defaults. Nothing is read or written until
`get_settings()` is called.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

from . import LOGGER

SETTINGS_VERSION = "0.1.0"


def config_dir() -> Path:
    base = os.environ.get("XDG_CONFIG_HOME", str(Path.home() / ".config"))
    return Path(base) / "dedark_yolo_tpu_torch"


class SettingsManager(dict):
    def __init__(self, file=None):
        self.file = Path(file) if file else config_dir() / "settings.json"
        root = Path.cwd()
        self.defaults = {
            "settings_version": SETTINGS_VERSION,
            "datasets_dir": str(root / "datasets"),
            "weights_dir": str(root / "weights"),
            "runs_dir": str(root / "runs"),
            "sync": False,          # no telemetry
            "tensorboard": True,
        }
        super().__init__(self.defaults)
        try:
            if self.file.is_file():
                loaded = json.loads(self.file.read_text(encoding="utf-8"))
                ok = (isinstance(loaded, dict)
                      and set(loaded) == set(self.defaults)
                      and all(isinstance(loaded[k], type(v))
                              for k, v in self.defaults.items())
                      and loaded["settings_version"] == SETTINGS_VERSION)
                if ok:
                    self.update(loaded)
                else:
                    LOGGER.info("settings out of date or corrupt; resetting "
                                f"to defaults at {self.file}")
                    self.save()
            else:
                self.save()
        except (OSError, ValueError) as e:
            LOGGER.info(f"settings load failed ({e}); using defaults")

    def save(self):
        self.file.parent.mkdir(parents=True, exist_ok=True)
        self.file.write_text(json.dumps(dict(self), indent=1) + "\n",
                             encoding="utf-8")

    def reset(self):
        self.clear()
        self.update(self.defaults)
        self.save()


_SETTINGS = None


def get_settings() -> SettingsManager:
    global _SETTINGS
    if _SETTINGS is None:
        _SETTINGS = SettingsManager()
    return _SETTINGS
