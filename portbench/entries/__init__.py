"""What a cell's window drives, one module per entry, found by the name in
a configuration's ``entry``. Each module has ``open_session(config,
traffic, seed, device, workdir, mesh=None)``, whose session (on ``mesh``'s
rank where the cell runs on several) warms up the cell's shapes
(``warm_up``), runs sweep point ``i`` of the run through the program's
public path (``run_point``) and lets go of the program's state
(``close``)."""
