"""Counterpart of the repo's ``experiments`` package: the study's sweeps
(``runs``) and figures (``plots``).

Imports neither submodule: ``runs`` runs sweeps on the card without
matplotlib, and ``plots`` draws on a host that has it."""
