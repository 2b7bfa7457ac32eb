# Sphinx configuration of the PyTorch port's pages (build them with
# ``sphinx-build docs/torch <out>``); the JAX package's site is docs/.
import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join("..", "..")))

project = "commpy-tpu (PyTorch port)"
copyright = "2026, commpy-tpu contributors"
author = "commpy-tpu contributors"
release = "0.1"

extensions = [
    "sphinx.ext.autodoc",
    "sphinx.ext.napoleon",
    "sphinx.ext.viewcode",
]

autodoc_member_order = "bysource"
autodoc_typehints = "description"
napoleon_numpy_docstring = True
napoleon_google_docstring = False
html_theme = "alabaster"
exclude_patterns = ["_build"]
