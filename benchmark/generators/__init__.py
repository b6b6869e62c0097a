"""The general generators that the traffic files name (``generator``)."""
