"""Parallel layout of the port: the named mesh over ranks (``mesh``), the
GPT and serving partition rules (``rules``) and the auto-layout planner
(``auto_layout``)."""
