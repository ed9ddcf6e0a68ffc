"""Logging wrappers (parity ``common/logging.h:34-68``: glog LOGI/LOGW/LOGE
+ init with an output directory).

Thin shims over the stdlib so the engine's diagnostics have the same
call-site shape as the reference; a file handler in the run output dir
mirrors ``FLAGS_log_dir`` (``fusion_ros.cc:105``).
"""

from __future__ import annotations

import logging
import os
import sys

_logger = logging.getLogger("ic_gvins_tpu_torch")


def initialization(output_dir: str | None = None, stderr: bool = True,
                   level: int = logging.INFO) -> None:
    """Configure the engine logger (parity ``Logging::initialization``)."""
    _logger.setLevel(level)
    _logger.handlers.clear()
    fmt = logging.Formatter(
        "%(levelname).1s%(asctime)s %(filename)s:%(lineno)d] %(message)s",
        datefmt="%m%d %H:%M:%S",
    )
    if stderr:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(fmt)
        _logger.addHandler(h)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        f = logging.FileHandler(os.path.join(output_dir, "ic_gvins_tpu_torch.log"))
        f.setFormatter(fmt)
        _logger.addHandler(f)


def LOGI(*args) -> None:
    _logger.info(" ".join(str(a) for a in args), stacklevel=2)


def LOGW(*args) -> None:
    _logger.warning(" ".join(str(a) for a in args), stacklevel=2)


def LOGE(*args) -> None:
    _logger.error(" ".join(str(a) for a in args), stacklevel=2)


def LOGF(*args) -> None:
    msg = " ".join(str(a) for a in args)
    _logger.critical(msg, stacklevel=2)
    raise RuntimeError(msg)
