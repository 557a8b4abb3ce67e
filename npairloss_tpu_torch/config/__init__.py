"""Prototxt configuration front end of the port: the text-format parser
and the typed net/solver views (``load_net``, ``load_solver``)."""
