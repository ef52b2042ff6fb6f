"""Optional napari plugin over the port's headless layers (counterpart of
``empanada_tpu/napari_plugin``): the same 24 commands (``napari.yaml``) as
thin magicgui adapters over ``empanada_tpu_torch.api``, ``.curation`` and
``.train``.  napari and magicgui are OPTIONAL dependencies: nothing here
imports them at module import time, and every widget factory raises an
informative ``ImportError`` when they are absent."""

from __future__ import annotations

import os

__all__ = ["napari_available", "manifest_path"]


def napari_available() -> bool:
    try:
        import magicgui  # noqa: F401
        import napari  # noqa: F401

        return True
    except ImportError:
        return False


def manifest_path() -> str:
    return os.path.join(os.path.dirname(__file__), "napari.yaml")
