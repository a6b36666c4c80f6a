"""Named loggers writing one ``thunder.log`` (port of
``thunder_tpu.utils.logging``; the reference's easylogging++ set-up,
src/Logging.cpp:6-27).

One file handler on the ``thunder`` root logger, a child logger per
subsystem under the JAX package's names (SYS, INIT, ROUND, COMPARE, RECO,
MESH, FFT, TPU, MEM), INFO to the file and not to stdout unless ``echo``.
"""

import logging
import os

LOGGER_NAMES = ("SYS", "INIT", "ROUND", "COMPARE", "RECO", "MESH", "FFT",
                "TPU", "MEM")

_ROOT = "thunder"


def init_logger(directory="./", filename="thunder.log", process_index=0,
                echo=False, level=logging.INFO):
    """Configure the thunder.log file handler in ``directory``; the last
    call wins. Returns the log file's path."""
    root = logging.getLogger(_ROOT)
    root.setLevel(level)
    root.propagate = False
    for h in list(root.handlers):
        root.removeHandler(h)
        h.close()
    os.makedirs(directory or "./", exist_ok=True)
    path = os.path.join(directory or "./", filename)
    fh = logging.FileHandler(path)
    fh.setFormatter(logging.Formatter(
        f"%(asctime)s %(levelname)s [host {process_index}]"
        " [%(name)s] %(message)s"))
    root.addHandler(fh)
    if echo:
        sh = logging.StreamHandler()
        sh.setFormatter(logging.Formatter(
            "%(levelname)s [%(name)s] %(message)s"))
        root.addHandler(sh)
    for name in LOGGER_NAMES:
        logging.getLogger(f"{_ROOT}.{name}")
    return path


def get_logger(name="SYS"):
    """Named logger, e.g. get_logger('ROUND')."""
    if name not in LOGGER_NAMES:
        raise ValueError(f"unknown logger {name!r}; one of {LOGGER_NAMES}")
    return logging.getLogger(f"{_ROOT}.{name}")
