"""The trace loop: scoring, KDE, selection and the driver."""
