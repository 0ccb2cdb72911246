"""Framework logger.

Re-design of reference ``autodist/utils/logging.py:33-107``: a dedicated
``autodist_tpu_torch`` logger writing PID-stamped records to stderr and to
a timestamped file under the ``logs`` directory of ``const.py``'s working
directory; verbosity controlled by the ``AUTODIST_MIN_LOG_LEVEL`` env flag.
"""
import logging as _logging
import os
import sys
import threading
import time

from autodist_tpu_torch.const import DEFAULT_LOG_DIR, ENV

_logger = None
_logger_lock = threading.Lock()

_FMT = '%(asctime)s %(levelname)s %(process)d ' \
       '%(filename)s:%(lineno)d] %(message)s'


def get_logger():
    """Return the singleton framework logger (double-checked locking)."""
    global _logger
    if _logger:
        return _logger
    with _logger_lock:
        if _logger:
            return _logger
        logger = _logging.getLogger('autodist_tpu_torch')
        logger.propagate = False
        level = ENV.AUTODIST_MIN_LOG_LEVEL.val.upper()
        logger.setLevel(level if hasattr(_logging, level) else 'INFO')
        fmt = _logging.Formatter(_FMT)
        sh = _logging.StreamHandler(sys.stderr)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        try:
            os.makedirs(DEFAULT_LOG_DIR, exist_ok=True)
            fh = _logging.FileHandler(
                os.path.join(DEFAULT_LOG_DIR, '%d.log' % int(time.time())))
            fh.setFormatter(fmt)
            logger.addHandler(fh)
        except OSError:  # read-only fs etc. -- stderr logging still works
            pass
        _logger = logger
        return _logger


def set_verbosity(level):
    """Set the logger level by name or numeric value."""
    get_logger().setLevel(level)


def debug(msg, *args, **kwargs):
    get_logger().debug(msg, *args, **kwargs)


def info(msg, *args, **kwargs):
    get_logger().info(msg, *args, **kwargs)


def warning(msg, *args, **kwargs):
    get_logger().warning(msg, *args, **kwargs)


def error(msg, *args, **kwargs):
    get_logger().error(msg, *args, **kwargs)
