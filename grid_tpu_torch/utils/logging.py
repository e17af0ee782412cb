"""Console logging (twin of ``grid_tpu/utils/logging.py``).

Every function works with ``console=None`` (plain ``print``), so library
use never needs ``rich``; where ``rich`` is missing :func:`make_console`
returns None and the CLI prints plainly.
"""

from __future__ import annotations

THEME = {
    "info": "cyan",
    "success": "bold green",
    "warning": "yellow",
    "danger": "bold red",
    "highlight": "magenta",
}


def make_console():
    """Build the themed console used by the CLI (ref: grid/cli.py:14-30),
    or None without ``rich``."""
    try:
        from rich.console import Console
        from rich.theme import Theme
    except ImportError:
        return None
    return Console(theme=Theme(THEME))


def log(console, msg, style=None):
    """Log a message to the rich console, or print if console is None
    (ref: grid/utils/utils.py:13-20)."""
    if console is not None:
        if style:
            console.print(msg, style=style)
        else:
            console.print(msg)
    else:
        print(msg)
