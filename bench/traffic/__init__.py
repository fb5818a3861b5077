"""Traffic mixes: one generator (`generator`) and one data file per mix
(``<name>.json``)."""
