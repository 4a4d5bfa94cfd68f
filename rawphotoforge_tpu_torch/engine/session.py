"""Settings persistence — the reference's settings files
(web/main.ts:268-316 localStorage; Godot user://settings.json
main.gd:258-284; python-legacy settings.json raw_photo_forge.py:85-157).

Keys and ranges mirror the web UI: uiPreviewSize 500-2000 (default 1280),
dragPreviewSize 100-800 (default 400), locale en/ja, plus the CUDA device
index (the Godot adapter picker, settings_window.gd:46-49). The JAX
package's ``engine/session.py``; the same file format and location, so the
two packages share one settings file.
"""

from __future__ import annotations

import dataclasses
import json
import os


def default_settings_path() -> str:
    """RPF_SETTINGS env override > repo-root .settings.json for a source
    checkout > per-user config dir (an installed package must not write
    into site-packages)."""
    env = os.environ.get("RPF_SETTINGS")
    if env:
        return env
    pkg_parent = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    if os.path.exists(os.path.join(pkg_parent, "pyproject.toml")):
        return os.path.join(pkg_parent, ".settings.json")
    base = os.environ.get("XDG_CONFIG_HOME",
                          os.path.join(os.path.expanduser("~"), ".config"))
    return os.path.join(base, "rawphotoforge_tpu", "settings.json")


@dataclasses.dataclass
class Settings:
    ui_preview_size: int = 1280
    drag_preview_size: int = 400
    locale: str = "en"
    device_index: int = 0
    jpeg_quality: int = 95

    def clamp(self) -> "Settings":
        def _int(v, lo, hi, default):
            try:
                return int(min(max(int(v), lo), hi))
            except (TypeError, ValueError):
                return default

        self.ui_preview_size = _int(self.ui_preview_size, 500, 2000, 1280)
        self.drag_preview_size = _int(self.drag_preview_size, 100, 800, 400)
        if self.locale not in ("en", "ja"):
            self.locale = "en"
        self.jpeg_quality = _int(self.jpeg_quality, 1, 100, 95)
        self.device_index = _int(self.device_index, 0, 4095, 0)
        return self

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "Settings":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known}).clamp()

    def save(self, path: str | None = None) -> None:
        # Write-then-rename so a crash mid-write can't corrupt the file.
        p = path or default_settings_path()
        parent = os.path.dirname(p)
        if parent:
            os.makedirs(parent, exist_ok=True)
        tmp = p + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_json(), f, indent=1)
        os.replace(tmp, p)

    @classmethod
    def load(cls, path: str | None = None) -> "Settings":
        p = path or default_settings_path()
        try:
            with open(p) as f:
                return cls.from_json(json.load(f))
        except (OSError, ValueError, TypeError, AttributeError):
            # TypeError/AttributeError: hand-edited non-dict JSON.
            return cls()

    def select_device(self):
        """The CUDA device ``device_index`` names, ``torch.device(
        "cuda:<i>")`` — the adapter picker of the reference
        (gpu_image_processing.rs:43-51, settings_window.gd:46-49). An index
        outside the visible devices returns None (the caller keeps the
        default card, like the reference's fallback to adapter 0). Without
        a card it raises ``PhotoEditorError``: the port never picks the
        CPU on its own."""
        import torch

        from .._device import resolve_device

        resolve_device(None)
        if not 0 <= self.device_index < torch.cuda.device_count():
            return None
        return torch.device(f"cuda:{self.device_index}")
