"""The user's entry points: the command line (``cli``) and the HTTP viewer
(``viewer``)."""
