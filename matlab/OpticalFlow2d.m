function varargout = OpticalFlow2d(varargin)
%OPTICALFLOW2D MATLAB/Octave front-end with the reference MEX call surface,
% backed by the JAX engine through the native C library (native/build.sh).
%
% Same five commands as the original MEX (WrapperOpticalFlow2d.cpp:18-155):
%   OpticalFlow2d([dimx dimy], niter, nscales, reg, regparams, nparams, ...
%                 nrefine, verbose)            % init
%   OpticalFlow2d(Iref, Imov)                  % register
%   motion = OpticalFlow2d()                   % get motion [dimx dimy 2]
%   Ireg  = OpticalFlow2d(Imov)                % warp
%   OpticalFlow2d()                            % close (nargout == 0)
%
% Setup: build native/build.sh, then set the environment variables
%   OF2D_LIB        -> path to libopticalflow2d.so
%   OF2D_PYTHONPATH -> repo root (so the engine package resolves)
% before calling. Works in MATLAB (loadlibrary/calllib) and Octave >= 7.

persistent dims loaded

if isempty(loaded)
    libpath = getenv('OF2D_LIB');
    if isempty(libpath)
        error('OpticalFlow2d: set OF2D_LIB to libopticalflow2d.so');
    end
    hdr = tempname();
    fid = fopen([hdr '.h'], 'w');
    fprintf(fid, [ ...
        'int of2d_init(int dimx, int dimy, const int* niter, int nscales,' ...
        ' int reg, const double* regparams, int nparams, int nrefine,' ...
        ' int verbose);\n' ...
        'int of2d_register_images(const double* iref, const double* imov);\n' ...
        'int of2d_get_motion(double* out);\n' ...
        'int of2d_warp(const double* img, double* out);\n' ...
        'int of2d_close(void);\n' ...
        'const char* of2d_last_error(void);\n']);
    fclose(fid);
    loadlibrary(libpath, [hdr '.h'], 'alias', 'of2d');
    loaded = true;
end

nin = nargin;
nout = nargout;

if nout == 0 && nin == 8
    % init
    d = varargin{1};
    niter = int32(varargin{2});
    nscales = varargin{3};
    reg = varargin{4};
    regparams = double(varargin{5});
    nparams = varargin{6};
    nrefine = varargin{7};
    verbose = varargin{8};
    rc = calllib('of2d', 'of2d_init', d(1), d(2), niter(1:nscales+1), ...
                 nscales, reg, regparams(1:nparams), nparams, nrefine, verbose);
    check(rc);
    dims = double(d(:)');
elseif nout == 0 && nin == 2
    % register: MATLAB arrays are column-major = the C API's x-fastest layout
    rc = calllib('of2d', 'of2d_register_images', ...
                 double(varargin{1}(:)), double(varargin{2}(:)));
    check(rc);
elseif nout == 1 && nin == 0
    % motion readback [dimx dimy 2]
    n = dims(1) * dims(2);
    buf = libpointer('doublePtr', zeros(2 * n, 1));
    rc = calllib('of2d', 'of2d_get_motion', buf);
    check(rc);
    v = buf.Value;
    varargout{1} = reshape(v, [dims(1), dims(2), 2]);
elseif nout == 1 && nin == 1
    % warp
    n = dims(1) * dims(2);
    buf = libpointer('doublePtr', zeros(n, 1));
    rc = calllib('of2d', 'of2d_warp', double(varargin{1}(:)), buf);
    check(rc);
    varargout{1} = reshape(buf.Value, [dims(1), dims(2)]);
elseif nout == 0 && nin == 0
    % close
    rc = calllib('of2d', 'of2d_close');
    check(rc);
else
    error('OpticalFlow2d: invalid number of input/output arguments');
end

end

function check(rc)
if rc ~= 0
    error('OpticalFlow2d: %s', calllib('of2d', 'of2d_last_error'));
end
end
