"""The plain reference the benchmark holds the program to: the frozen
plain path (``frozen/``) and the steps and frames built on it."""
