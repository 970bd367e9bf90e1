"""Yardsticks that later changes to the port cannot move: inputs made from
the seed, work counts, peaks and trace arithmetic."""
