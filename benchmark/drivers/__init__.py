"""The drivers, one module per traffic ``kind``: ``<kind>.py`` defines
``Driver``."""
