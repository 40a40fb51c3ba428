"""Ground-truth oracle runs completed in the window x 3600 / the window's
seconds: ``runs_per_hour``'s reading, kept apart because the oracle's
noise is of another kind."""

from portbench.spec import reader

read = reader("e2e", "runs_per_hour").read
