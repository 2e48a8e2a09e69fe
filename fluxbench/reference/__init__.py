"""Plain references, one module per kind of configuration
(``configs/<config>.json`` names its module under ``reference``). They import
numpy, scipy and torch only: nothing of the program under test."""
