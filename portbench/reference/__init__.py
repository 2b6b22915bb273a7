"""The benchmark's plain reference of the ndzip codec (see ``codec``)."""
