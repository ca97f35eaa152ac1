"""The general drivers, one a kind of traffic; a traffic file names its
own (`"driver"`), and run.py imports it by that name."""
