"""How full the stage-2 step's static passing budget runs, in %: 100 x
the passing samples kept (a step's min(demand, budget)) over the passing
budgets, summed over the window's steps (the program's counters
``budget.train``, summed on the device). Nothing is read where the
program keeps no such counters."""
from benchmark.spans import budget_fill, program_record


def read(r):
    return budget_fill(program_record(), "budget.train")
