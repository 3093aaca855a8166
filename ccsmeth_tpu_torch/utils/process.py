"""Small process/config helpers (reference process_utils.py:88-97,230-266)."""

from __future__ import annotations

import os
import sys
from subprocess import PIPE, Popen


def str2bool(v: str | bool) -> bool:
    """yes/true/t/1 -> True (process_utils.py:88-90)."""
    if isinstance(v, bool):
        return v
    return v.lower() in ("yes", "true", "t", "1")


def is_file_empty(file_name: str) -> bool:
    return os.path.isfile(file_name) and os.path.getsize(file_name) == 0


def display_args(args, is_stderr: bool = True) -> None:
    """Echo every parsed arg (process_utils.py:230-245)."""
    out = sys.stderr if is_stderr else sys.stdout
    out.write("# ===============================================\n## parameters: \n")
    for k, v in vars(args).items():
        if k != "func":
            out.write("{}:\n\t{}\n".format(k, v))
    out.write("# ===============================================\n")
    out.flush()


def run_cmd(cmd: str):
    """Run a shell command, return ((stdout, stderr), returncode) (process_utils.py:249-253)."""
    proc = Popen(cmd, shell=True, stdout=PIPE, stderr=PIPE)
    stdinfo = proc.communicate()
    return stdinfo, proc.returncode
