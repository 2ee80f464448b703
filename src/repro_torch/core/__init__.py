"""Protocol core: merge strategies, compat rules, byte models, schedule."""
