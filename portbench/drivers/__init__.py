"""The drivers of the traffic mixes, one module per kind (a traffic file's
``driver``): each sets up the program for a cell, runs its unit of work, and
compares what the timed path produced with the reference."""
