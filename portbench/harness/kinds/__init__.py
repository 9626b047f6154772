"""The traffic generators: each traffic file's ``kind`` names one module here,
which builds the program's session for a cell, drives its measured window
and checks what the window's path produced against the plain reference."""

import importlib


def get(kind: str):
    return importlib.import_module(f"portbench.harness.kinds.{kind}")
